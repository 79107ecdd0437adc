"""The recalculate_all idempotence gate (runtime/partials.py): a full
recompute is skipped exactly when nothing mutated since the last one —
and never skipped after a mutation, a model change, or a re-root."""
import os

from maple_jax.config import MapleConfig
from maple_jax.pipeline import Run

EXAMPLE = "/root/reference/example_files/MAPLE_alignment_example.txt"


def _count_inner(rt):
    calls = {"n": 0}
    orig = rt._recalculate_all

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    rt._recalculate_all = counted
    return calls


def test_recalc_skip_and_invalidation(tmp_path):
    cfg = MapleConfig(input=EXAMPLE, output=str(tmp_path / "g"),
                      model="GTR", overwrite=True)
    run = Run(cfg)
    run.load()
    run.build_initial_tree()
    rt = run.rt
    root = run.root
    calls = _count_inner(rt)

    rt.recalculate_all(root)
    assert calls["n"] == 1
    lk1 = rt.calculate_tree_likelihood(root)
    # clean: second recompute is a no-op
    rt.recalculate_all(root)
    assert calls["n"] == 1
    # reading the LK does not invalidate
    rt.calculate_tree_likelihood(root)
    rt.recalculate_all(root)
    assert calls["n"] == 1

    # a model change invalidates
    rt.model.version += 1
    rt.recalculate_all(root)
    assert calls["n"] == 2

    # a vector mutation invalidates
    rt.mark_mutated()
    rt.recalculate_all(root)
    assert calls["n"] == 3
    assert rt.calculate_tree_likelihood(root) == lk1

    # the env escape hatch forces the recompute
    os.environ["MAPLE_NO_RECALC_SKIP"] = "1"
    try:
        rt.recalculate_all(root)
        assert calls["n"] == 4
    finally:
        del os.environ["MAPLE_NO_RECALC_SKIP"]

    # skipped state is bit-stable: LK unchanged through all of the above
    assert rt.calculate_tree_likelihood(root) == lk1
