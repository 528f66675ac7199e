"""StageTimer / device_trace — the observability layer (SURVEY.md §6.1)."""
import numpy as np

from sitator_tpu.util.timing import StageTimer, device_trace


def test_stage_timer_report():
    t = StageTimer("demo")
    with t.stage("alpha"):
        sum(range(1000))
    with t.stage("beta"):
        sum(range(1000))
    assert len(t.stages) == 2
    assert t.total >= 0.0
    rep = t.report()
    assert "alpha" in rep and "beta" in rep and "TOTAL" in rep
    # percentages line up
    assert abs(sum(s for _, s in t.stages) - t.total) < 1e-12


def test_stage_timer_empty_report():
    t = StageTimer()
    rep = t.report(log=True)
    assert "TOTAL" in rep and t.total == 0.0


def test_device_trace_writes_profile(tmp_path):
    import jax.numpy as jnp
    d = tmp_path / "trace"
    with device_trace(str(d)):
        np.asarray(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    # the profiler must have produced SOMETHING under the trace dir
    assert any(d.rglob("*")), "no trace artifacts written"


def test_stage_timer_trace_dir(tmp_path):
    import jax.numpy as jnp
    t = StageTimer()
    with t.stage("traced", trace_dir=str(tmp_path / "t")):
        np.asarray(jnp.ones((4, 4)) + 1.0)
    assert t.stages[0][0] == "traced"
