"""The benchmark's harness: finding a cell's files (``cells``), driving the
program through its runner (``window``), reading the profiler's trace
(``trace``), the published peaks (``peaks``) and the output check
(``check``)."""
