"""Native error-model path: alias-tagged shared ambiguity lists.

The reference shares one mutable probability list per tip ambiguity code
(:3959) and passthrough merge branches keep referencing it, so an
error-model refresh of one tip changes cached vectors everywhere.  The
native backend reproduces this with alias tags + store_patch_tag; these
tests pin (a) the micro-semantics of drift through a passthrough merge
and (b) byte parity of the full 3,000-sample error pipeline against the
Python-kernel oracle (goldens generated with kernel_backend=python,
whose outputs equal the reference's semantics)."""
import os

import pytest

from maple_jax.config import MapleConfig
from maple_jax.pipeline import run_inference

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "goldens")
B3000 = os.path.join(HERE, "data_b1429_3000.maple.gz")

native = pytest.importorskip("maple_jax.native")
if not native.native_available():
    pytest.skip("native library unavailable", allow_module_level=True)


def test_tagged_passthrough_merge_drifts_with_patch():
    """A tagged O entry copied through an O-vs-N merge branch must follow
    later patches of its shared list, exactly like the Python kernels'
    list reuse."""
    from maple_jax.config import DerivedConfig
    from maple_jax.refdata import Model, RefData

    ref = "ACGT" * 25
    refd = RefData.build(ref, model="JC")
    dc = DerivedConfig.build(MapleConfig(model="JC"), refd.lRef)
    store = native.NativeStore(refd, dc)
    model = Model.initial(refd, "JC")
    model.using_error_rate = True
    model.set_error_rates(1e-4, None)
    store.sync_model(model)

    shared = [0.0, 0.5, 0.0, 0.5]
    tip = [(6, 0, shared), (4, refd.lRef)]          # O at pos 1, R to end
    other = [(5, 2), (4, refd.lRef)]                # N over pos 1..2
    h_tip = store.from_tuples(tip, tags=[7, -1])
    h_other = store.from_tuples(other)
    # lower merge with bl2=0: the O survives against N via the
    # passthrough branch (python reuses the list object)
    h_merged = store.merge(h_tip, 0.0, False, h_other, 0.0, False)
    assert store.export_tags(h_merged)[0] == 7
    # mutate the shared list and patch by tag: both the tip vector and
    # the merge product must change
    shared[:] = [0.1, 0.4, 0.1, 0.4]
    store.patch_tag(7, shared)
    assert store.to_tuples(h_merged)[0][-1] == shared
    assert store.to_tuples(h_tip)[0][-1] == shared
    # a lazily-annotated copy (branch length recorded, list reused by the
    # python kernels too) keeps the tag...
    h_lazy = store.merge(h_tip, 1e-4, True, h_other, 1e-4, False)
    assert store.export_tags(h_lazy)[0] == 7
    # ...but an evolved (computed) O — upper/total merge evolves the
    # surviving O through the branch — must NOT carry it
    h_evolved = store.merge(h_other, 0.0, False, h_tip, 1e-4, False,
                            is_up_down=True)
    tags = store.export_tags(h_evolved)
    types = [e[0] for e in store.to_tuples(h_evolved)]
    assert 6 in types and tags[types.index(6)] == -1


def _compare(out, golden_prefix):
    for part in ("_tree.tree", "_subs.txt", "_LK.txt",
                 "_estimatedErrors.txt"):
        with open(out + part) as f, open(golden_prefix + part) as g:
            assert f.read() == g.read(), f"{part} differs"


def test_b3000_estimate_errors_native_golden(tmp_path):
    """Full --estimateErrors pipeline on 3,000 samples with the native
    backend (alias-tag machinery end to end: activation window, backend
    restore, tagged merges, refresh patching, native SPR rounds).  The
    divergence this pins only appears beyond ~1,500 samples, where
    refreshes mutate shared lists mid-recompute after passthrough merges
    have cached references."""
    if not os.path.isfile(os.path.join(GOLDEN, "b3000_errest_tree.tree")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=B3000, output=out, model="UNREST",
                      estimateErrors=True, overwrite=True)
    run_inference(cfg)
    _compare(out, os.path.join(GOLDEN, "b3000_errest"))
