"""Frame thinning: keep a target effective fps (or every Nth frame) from a
frame directory and delete the rest.

Parity: reference cleanup/cleanup_python.py:20-87 (fps-based) and
cleanup/cleanup_julia.py:16-47 (every-Nth). The reference's interactive
"Proceed? (y/n)" prompt (cleanup_python.py:72-76) is available as
``confirm=True`` (library callers keep the explicit ``dry_run`` flag;
a callable ``confirm`` substitutes for ``input`` in tests).
"""

from __future__ import annotations

from pathlib import Path


def thin_frames(
    frame_dir,
    keep_every: int | None = None,
    source_fps: float | None = None,
    target_fps: float | None = None,
    pattern: str = "*.png",
    dry_run: bool = False,
    confirm=False,
) -> dict:
    """Delete frames so that either every ``keep_every``-th frame remains,
    or the effective rate drops from ``source_fps`` to ``target_fps``.

    ``confirm``: False (default) deletes without asking; True prompts
    "delete N of M frames ... ? [y/N]" on stdin before deleting
    (reference parity, cleanup_python.py:72-76); a callable is invoked
    with that prompt string and truthy/"y" means proceed.

    Returns {"kept": n, "deleted": n, "deleted_paths": [...]}.
    """
    frames = sorted(Path(frame_dir).glob(pattern))
    if keep_every is None:
        if not (source_fps and target_fps) or target_fps >= source_fps:
            keep_every = 1
        else:
            keep_every = max(1, round(source_fps / target_fps))
    keep = set(frames[::keep_every])
    doomed = [f for f in frames if f not in keep]
    if confirm and doomed and not dry_run:
        prompt = (f"delete {len(doomed)} of {len(frames)} frames in "
                  f"{frame_dir}? [y/N] ")
        try:
            if callable(confirm):
                ans = confirm(prompt)
            else:
                # prompt on stderr: the CLI's stdout is a machine-readable
                # JSON line and input(prompt) would glue it to the prompt
                import sys

                sys.stderr.write(prompt)
                sys.stderr.flush()
                ans = input()
        except EOFError:  # no stdin (piped/batch run): refuse to delete
            ans = "n"
        if not (ans is True or str(ans).strip().lower() in ("y", "yes")):
            return {"kept": len(frames), "deleted": 0, "deleted_paths": [],
                    "aborted": True}
    if not dry_run:
        for f in doomed:
            f.unlink()
    return {
        "kept": len(frames) - len(doomed),
        "deleted": len(doomed),
        "deleted_paths": doomed,
    }
