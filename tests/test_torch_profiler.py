"""vnl_tpu_torch.utils.profiler against vnl_tpu.utils.profiler on the CPU:
PhaseTimer's summary has the JAX package's keys and counts, and trace()
writes a trace file that TensorBoard or Chrome opens."""

import glob
import json
import os

import jax.numpy as jnp
import torch

from vnl_tpu.utils import profiler as jprof
from vnl_tpu_torch.utils import profiler as tprof


def test_phase_timer_summary_has_the_jax_keys():
    jt, tt = jprof.PhaseTimer(), tprof.PhaseTimer()
    for name, reps in (("rollout", 3), ("sgd", 2), ("eval", 1)):
        for _ in range(reps):
            with jt.phase(name, block_on=jnp.ones(4) * 2):
                pass
            with tt.phase(name, block_on={"x": [torch.ones(4) * 2]}):
                pass
    with tt.phase("plain"):
        pass
    with jt.phase("plain"):
        pass
    got, want = tt.summary(), jt.summary()
    assert sorted(got) == sorted(want) == sorted(
        f"profile/{k}_ms" for k in ("rollout", "sgd", "eval", "plain"))
    assert tt.counts == jt.counts
    assert all(v >= 0.0 for v in got.values())


def test_trace_writes_a_trace_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as d:
        assert d == log_dir
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
