"""Native C++ kernels must be byte-identical to the Python host kernels."""
import math
import random

import pytest

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.core import kernels as K
from maple_jax.refdata import Model, RefData

from test_kernels_vs_reference import build_ctx, random_genome_list

native = pytest.importorskip("maple_jax.native")
if not native.native_available():
    pytest.skip("native library unavailable", allow_module_level=True)


MODES = [("GTR", False, "none"), ("GTR", True, "none"),
         ("GTR", False, "global"), ("UNREST", True, "site")]


def make_store(refmod, model_name, rate_var, error_mode, seed):
    import test_kernels_vs_reference as tk
    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=seed)
    model = tk.last_built_model[0]
    cfg = MapleConfig(model=model_name)
    dc = DerivedConfig.build(cfg, model.refd.lRef)
    store = native.NativeStore(model.refd, dc)
    store.sync_model(model)
    return ctx, store


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_native_roundtrip_and_merge(refmod, model_name, rate_var,
                                    error_mode):
    ctx, store = make_store(refmod, model_name, rate_var, error_mode, 21)
    rng = random.Random(99)
    for trial in range(60):
        # upper lists (with root-crossing entries) feed only upDown merges;
        # lower merges take plain lower lists — matching real usage (the
        # reference has a latent dead-path quirk for the impossible combo)
        v1u = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                 upper=True)
        v1l = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        v2 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        h1u = store.from_tuples(v1u)
        assert store.to_tuples(h1u) == [tuple(e) for e in v1u]
        h1l = store.from_tuples(v1l)
        h2 = store.from_tuples(v2)
        bl1 = rng.choice([0.0, 1e-4, 3.3e-5])
        bl2 = rng.choice([0.0, 1e-4])
        tip1, tip2 = rng.random() < 0.5, rng.random() < 0.5
        for upd in (False, True):
            t1 = False if upd else tip1
            v1 = v1u if upd else v1l
            h1 = h1u if upd else h1l
            py = K.merge_vectors(ctx, v1, bl1, t1, v2, bl2, tip2,
                                 is_up_down=upd)
            hm = store.merge(h1, bl1, t1, h2, bl2, tip2, is_up_down=upd)
            if py is None:
                assert hm is None
            else:
                assert store.to_tuples(hm) == [tuple(e) for e in py], \
                    f"merge mismatch (upd={upd}) trial {trial}"
                store.release(hm)
        v1, h1 = v1l, h1l
        # merge with LK (lower x lower)
        if bl1 and bl2:
            py, py_lk = K.merge_vectors(ctx, v1, bl1, tip1, v2, bl2, tip2,
                                        return_lk=True, n_minor1=1,
                                        n_minor2=2)
            hm, na_lk = store.merge_lk(h1, bl1, tip1, h2, bl2, tip2,
                                       n_minor1=1, n_minor2=2)
            assert na_lk == py_lk
            assert store.to_tuples(hm) == [tuple(e) for e in py]
            store.release(hm)
        # append scores (upper parent x lower child)
        blen = rng.choice([0.0, 3.3e-5, 1e-4])
        is_tip = rng.random() < 0.5
        py_score = K.append_prob_node(ctx, v1u, v2, is_tip, blen)
        na_score = store.append(h1u, h2, is_tip, blen)
        assert na_score == py_score or (
            math.isinf(py_score) and math.isinf(na_score)), \
            f"append mismatch trial {trial}: {py_score} vs {na_score}"
        store.release(h1u)
        store.release(h1l)
        store.release(h2)


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_native_blen_pass_root(refmod, model_name, rate_var, error_mode):
    from maple_jax.core import genomelist as gl
    ctx, store = make_store(refmod, model_name, rate_var, error_mode, 31)
    rng = random.Random(77)
    for trial in range(60):
        vP = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True)
        vC = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        hP = store.from_tuples(vP)
        hC = store.from_tuples(vC)
        from_tip = rng.random() < 0.5
        py_t = K.estimate_branch_length(ctx, vP, vC, from_tip_c=from_tip)
        na_t = store.blen(hP, hC, from_tip)
        assert na_t == py_t, f"blen trial {trial}: {na_t} vs {py_t}"
        # pass through branch
        n_mut = rng.randint(0, 6)
        muts = []
        for pp in sorted(rng.sample(range(1, ctx.lRef + 1), n_mut)):
            a, b = rng.sample(range(4), 2)
            muts.append((pp, a, b))
        for up in (False, True):
            py_v = gl.pass_through_branch(ctx.lRef, vC, muts, dir_is_up=up)
            hv = store.pass_through(hC, muts, dir_is_up=up)
            assert store.to_tuples(hv) == [tuple(e) for e in py_v]
            store.release(hv)
        # root vector + prob root
        blen = rng.choice([0.0, False, 1e-4])
        tip = rng.random() < 0.5
        py_r = K.root_vector_frame(ctx, vC, blen, tip)
        gl.shorten(py_r, ctx.threshold_prob)
        hr = store.root_vector(hC, blen, tip, shorten=True)
        assert store.to_tuples(hr) == [tuple(e) for e in py_r]
        store.release(hr)
        assert store.find_prob_root(hC) == K.find_prob_root_frame(ctx, vC)
        # different / minor
        vC2 = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        hC2 = store.from_tuples(vC2)
        assert store.different(hC, hC2) == K.are_vectors_different(
            ctx, vC, vC2)
        assert store.minor(hC, hC2) == K.is_minor_sequence(
            ctx.lRef, vC, vC2)
        assert store.minor(hC, hC2, True) == K.is_minor_sequence(
            ctx.lRef, vC, vC2, only_find_identical=True)
        # pseudo counts
        c_py = [[0.0] * 4 for _ in range(4)]
        c_na = [[0.0] * 4 for _ in range(4)]
        K.update_pseudo_counts(ctx.lRef, vC, vC2, c_py)
        store.pseudo_counts(hC, hC2, c_na)
        assert c_py == c_na
        store.release(hP)
        store.release(hC)
        store.release(hC2)
