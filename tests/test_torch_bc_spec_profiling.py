"""Two small public helpers of the port against the JAX package:
``boundary.apply_bc_spec`` (a sides dict of Dirichlet
values, Neumann copies and a callable, applied in ``SIDES`` order, so the
corners take the last write) on a seeded field, bit for bit; and
``utils/profiling.profiler_trace``, which writes a Chrome trace of the
block into its directory and does nothing for ``None``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import boundary as jb
from cfdsim_tpu_torch import boundary as tb
from cfdsim_tpu_torch.utils.profiling import profiler_trace


def _specs(lib, xp):
    return {
        "x_lo": ("dirichlet", 1.5),
        "x_hi": ("neumann",),
        "y_lo": ("dirichlet", xp.asarray(np.linspace(0.0, 1.0, 12, dtype=np.float32))),
        "y_hi": lambda f: lib.copy_edge(f, "y_hi") * 2.0,
    }


@pytest.mark.parametrize("sides", [("x_lo", "x_hi", "y_lo", "y_hi"), ("y_lo", "x_hi"),
                                   ("y_hi",)])
def test_apply_bc_spec_matches_jax(sides):
    field = np.random.default_rng(4).standard_normal((9, 12)).astype(np.float32)
    js = {k: v for k, v in _specs(jb, jnp).items() if k in sides}
    ts = {k: v for k, v in _specs(tb, torch).items() if k in sides}
    want = np.asarray(jb.apply_bc_spec(jnp.asarray(field), js))
    got = tb.apply_bc_spec(torch.from_numpy(field.copy()), ts).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_bc_spec_refuses_unknown_bc():
    with pytest.raises(ValueError, match="unknown bc"):
        tb.apply_bc_spec(torch.zeros(4, 4), {"x_lo": ("robin", 1.0)})


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(tmp_path / "trace"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("matmul" in e.get("name", "") for e in trace["traceEvents"])
    with profiler_trace(None):  # a no-op
        torch.ones(2).sum()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace"]
