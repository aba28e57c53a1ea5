"""The port's utilities and last public layers against the JAX package.

- ``utils.diagnostics``: the printout, the CPU's empty memory report, the
  self-check, and ``backend_differential_suite`` on the CPU: JAX's keys
  (no fused entry on a CPU-only host, as in JAX), the same ``max_err``
  (0 but for ``conv_bf16``, which holds the bf16 conv against the float32
  one in both packages), and the port's CPU pipeline within JAX's table
  of JAX's own CPU pipeline.
- ``utils.gradcheck`` on a sparse conv (JAX's ``tests/test_nn.py``
  case), ``utils.profiling``, and ``count_params`` equal to JAX's on the
  VAE, the UNet, the VQ-VAE and MinkUNet (the flax shapes from
  ``jax.eval_shape``: no ``init`` compiles).
- The group-E layers (``InstanceNorm``, ``StableGroupNorm``,
  ``AdaStableInstanceNorm``, ``GroupNormDense``, ``HjmInstanceNorm`` with
  its running statistics, ``LinearPositionalEncoding``, the sparse
  ``Linear``) at 1e-5, weights carried by ``utils.convert``.
- ``ops``: ``origin_grid``, ``hybrid_region_offsets`` and the
  ``dense_conv_applicable`` routing decision exactly; the opt-in dense
  route taken only where the fused route is off.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu as mt
import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu import models as mm
from mink_octtree_stablediffusion_tpu.ops import dense_conv as jdense
from mink_octtree_stablediffusion_tpu.ops import kernels as jkernels
from mink_octtree_stablediffusion_tpu_torch.ops import dense_conv as pdense
from mink_octtree_stablediffusion_tpu_torch.utils import diagnostics
from mink_octtree_stablediffusion_tpu_torch.utils.convert import load_flax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _tensors(stride=1, cap=256, cin=8, ext=10, bsz=3, n=90,
             empty_instance=1):
    """The same sparse tensor in both packages (one built per argument
    set), instance ``empty_instance`` without voxels."""
    rng = np.random.RandomState(100 + stride + cap)
    coords = []
    for b in range(bsz):
        if b == empty_instance:
            continue
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0) * stride
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    coords = np.concatenate(coords).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(coords, cap)
    feats = (rng.randn(cap, cin) * 2 + 0.5) * valid[:, None]
    feats = feats.astype(np.float32)
    kw = dict(capacity=cap, batch_size=bsz, stride=stride,
              extent=(ext * stride,) * 3)
    jst = jax.jit(lambda c, f, v: mt.sparse_tensor(c, f, valid=v, **kw))(
        jnp.asarray(cpad), jnp.asarray(feats), jnp.asarray(valid))
    pst = mp.sparse_tensor(_t(cpad), _t(feats), valid=_t(valid), **kw)
    return jst, pst


def _carry(jmod, pmod, rng, *args, **kw):
    abstract = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kw), *args)

    def draw(path, x):
        a = rng.randn(*x.shape).astype(np.float32) * 0.3
        if str(path[-1].key) == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)
    variables = jax.tree_util.tree_map_with_path(draw, abstract)
    load_flax(pmod, variables)
    return variables


def test_diagnostics_on_the_cpu():
    buf = io.StringIO()
    diagnostics.print_diagnostics(file=buf)
    text = buf.getvalue()
    assert "torch: " + torch.__version__ in text and "cuda devices:" in text
    assert mp.utils.get_device_memory_info() == {}
    assert mp.utils.backend_selfcheck(device="cpu")
    assert mp.utils.backend_selfcheck(n=512, res=6, seed=3, device="cpu")


def _jax_pipeline(n=1024, res=12, seed=0):
    """The JAX package's differential pipeline on its CPU (float32 at
    'highest', the bf16 conv)."""
    cpad, valid, feats, kernel = map(jnp.asarray,
                                     diagnostics.differential_inputs(
                                         n, res, seed))
    spec = mt.ops.KernelSpec(3, 1, ndim=3)

    def pipeline(cd):
        grid, inverse, _ = mt.ops.make_grid(cpad, valid, n, batch_size=2,
                                            extent=(res,) * 3)
        f = mt.ops.reduce_by_inverse(feats, inverse, valid, n, "sum")
        nbr = mt.ops.kernel_map(grid, grid, spec)
        conv = mt.ops.sparse_conv_apply(f, kernel, nbr, compute_dtype=cd)
        bid = jnp.where(grid.valid, grid.coords[:, 0], 2)
        pooled, _ = mt.ops.global_pool(f, bid, 2, grid.valid, "avg")
        return {"geometry_keys": grid.coords, "geometry_valid": grid.valid,
                "reduce": f, "conv": conv, "global_pool": pooled}
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda: pipeline(jnp.float32))()
    out["conv_bf16"] = jax.jit(lambda: pipeline(jnp.bfloat16)["conv"])()
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_differential_suite_on_the_cpu_matches_jax():
    got = mp.utils.backend_differential_suite(device="cpu")
    ref = mt.utils.backend_differential_suite()
    assert set(got) == set(ref) and "conv_fused_bf16" not in got
    assert got["_all_ok"] and ref["_all_ok"]
    for k, v in ref.items():
        if k == "_all_ok":
            continue
        assert got[k]["tol"] == v["tol"]
        if k == "conv_bf16":
            assert 0 < got[k]["max_err"] <= v["tol"]
            assert abs(got[k]["max_err"] - v["max_err"]) < 1e-4
        else:
            assert got[k]["max_err"] == v["max_err"] == 0.0, k
    outs = diagnostics.differential_outputs("cpu", fused=False)
    jouts = _jax_pipeline()
    assert set(outs) == set(jouts)
    for k, tol in diagnostics.TOLERANCES.items():
        if k in outs:
            np.testing.assert_allclose(outs[k], jouts[k], rtol=0, atol=tol,
                                       err_msg=k)


def test_gradcheck_sparse_conv(rng):
    coords = np.concatenate(
        [np.zeros((12, 1), np.int32), rng.randint(0, 3, (12, 3))],
        axis=1).astype(np.int32)
    cpad, valid = mp.ops.pad_to_capacity(coords, 16)
    st = mp.sparse_tensor(
        _t(cpad), _t((rng.randn(16, 2) * valid[:, None]).astype(np.float32)),
        capacity=16, valid=_t(valid))
    spec = mp.ops.KernelSpec(3, 1, ndim=3)
    nbr = mp.ops.kernel_map(st.grid, st.grid, spec)
    kernel = _t(rng.randn(27, 2, 3).astype(np.float32) * 0.2)

    def f(feats, kern):
        return mp.ops.sparse_conv_apply(feats, kern, nbr,
                                        compute_dtype=torch.float64)
    assert mp.utils.gradcheck(f, (st.features, kernel))
    assert mp.utils.gradcheck(lambda x: (x ** 3).sum(), (kernel,), order=2)
    with pytest.raises(Exception):
        mp.utils.gradcheck(lambda x: x.detach() * 2 + x, (kernel,),
                           atol=1e-6, rtol=1e-6)


def test_profiling(tmp_path):
    timer = mp.utils.Timer()
    for _ in range(3):
        timer.tic()
        timer.toc()
    assert timer.calls == 3 and timer.min <= timer.avg <= timer.max
    assert "calls=3" in str(timer)
    calls = []
    t = mp.utils.synced_time(lambda x: calls.append(x), 1, iters=4,
                             warmup=2)
    assert len(calls) == 6 and t >= 0
    with mp.utils.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def _abstract_params(jmod, *args):
    variables = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args)
    return int(sum(np.prod(x.shape) for x in
                   jax.tree.leaves(variables["params"])))


def test_count_params_matches_jax():
    """The VQ-VAE and MinkUNet; the VAE and the UNet are counted in
    ``test_torch_checkpoint_import.py``, beside their flax trees."""
    cap, b = 512, 2

    def st(channels):
        return jax.eval_shape(lambda c, v: mt.sparse_tensor(
            c, jnp.ones((cap, channels)), capacity=cap, batch_size=b,
            valid=v, extent=(16,) * 3), jnp.zeros((cap, 4), jnp.int32),
            jnp.zeros((cap,), bool))
    vch, enc, dec = (4, 8, 8, 8, 4), (256, 128, 64, 64, 64), \
        (64, 128, 256, 512)
    s1 = st(1)
    jvq = mm.VQVAE(channels=vch, num_embeddings=8, encoder_capacities=enc,
                   decoder_capacities=dec)
    pvq = mp.models.VQVAE(vch, 8, enc, dec, device="cpu")
    assert mp.utils.count_params(pvq) == _abstract_params(
        jvq, s1, s1.grid)
    assert mp.utils.count_params(dict(pvq.named_parameters())) == \
        mp.utils.count_params(pvq.parameters())
    narrow = dict(planes=(4, 8, 8, 8, 8, 8, 4, 4), init_dim=4,
                  input_capacity=cap)
    jseg = mm.MinkUNet14(out_channels=3, **narrow)
    pseg = mp.models.MinkUNet14(3, **narrow, device="cpu")
    assert mp.utils.count_params(pseg) == _abstract_params(jseg, st(3))
    text = mp.utils.summary(pseg, depth=1)
    assert text.splitlines()[-1].split()[-1] == \
        f"{mp.utils.count_params(pseg):,}"
    # buffers (running statistics) are not parameters
    assert mp.utils.count_params(pseg) < sum(
        t.numel() for t in pseg.state_dict().values())


def test_instance_norms_match_jax(rng):
    jst, pst = _tensors()
    for jm, pm in ((mt.nn.InstanceNorm(), mp.nn.InstanceNorm(8)),
                   (mt.nn.StableGroupNorm(), mp.nn.StableGroupNorm(8))):
        v = _carry(jm, pm, rng, jst)
        ref = jax.jit(lambda v, x: jm.apply(v, x).features)(v, jst)
        np.testing.assert_allclose(_np(pm(pst).features), np.asarray(ref),
                                   **TOL)
    emb = rng.randn(3, 5).astype(np.float32)
    jm, pm = mt.nn.AdaStableInstanceNorm(), mp.nn.AdaStableInstanceNorm(8, 5)
    v = _carry(jm, pm, rng, jst, jnp.asarray(emb))
    ref = jax.jit(lambda v, x, e: jm.apply(v, x, e).features)(
        v, jst, jnp.asarray(emb))
    np.testing.assert_allclose(_np(pm(pst, _t(emb)).features),
                               np.asarray(ref), **TOL)
    fresh = mp.nn.AdaStableInstanceNorm(8, 5)
    assert 0 < fresh.fc.weight.std() < 0.05 and not fresh.fc.bias.any()


def test_hjm_instance_norm_matches_jax(rng):
    jst, pst = _tensors()
    jm, pm = mt.nn.HjmInstanceNorm(momentum=0.8), \
        mp.nn.HjmInstanceNorm(8, momentum=0.8)
    v = _carry(jm, pm, rng, jst, train=False)
    (ref, upd) = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jst)
    got = pm.train()(pst)
    np.testing.assert_allclose(_np(got.features), np.asarray(ref.features),
                               **TOL)
    np.testing.assert_allclose(_np(pm.running_mean),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(_np(pm.running_var),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False).features)(v, jst)
    np.testing.assert_allclose(_np(pm.eval()(pst).features),
                               np.asarray(ref), **TOL)


def test_group_norm_dense_matches_jax(rng):
    x = rng.randn(2, 3, 4, 5, 12).astype(np.float32) * 2 + 1
    jm, pm = mt.nn.GroupNormDense(num_groups=3), mp.nn.GroupNormDense(12, 3)
    v = _carry(jm, pm, rng, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(_np(pm(_t(x))), np.asarray(ref), **TOL)
    with pytest.raises(ValueError):
        mp.nn.GroupNormDense(12, 5)


def test_linear_and_positional_encoding_match_jax(rng):
    jst, pst = _tensors(stride=4)
    jm, pm = mt.nn.LinearPositionalEncoding(d_model=6), \
        mp.nn.LinearPositionalEncoding(6)
    v = _carry(jm, pm, rng, jst)
    np.testing.assert_allclose(_np(pm(pst)), np.asarray(jm.apply(v, jst)),
                               **TOL)
    for bias in (True, False):
        jm = mt.nn.Linear(out_channels=5, use_bias=bias)
        pm = mp.nn.Linear(8, 5, use_bias=bias)
        v = _carry(jm, pm, rng, jst)
        np.testing.assert_allclose(
            _np(pm(pst).features),
            np.asarray(jax.jit(lambda v, x: jm.apply(v, x).features)(v, jst)),
            **TOL)
    m = 40
    coords = np.concatenate([np.zeros((m, 1)), rng.rand(m, 3) * 5], 1)
    feats = rng.randn(m, 8).astype(np.float32)
    valid = np.arange(m) < 30
    jf = mt.TensorField(coordinates=jnp.asarray(coords, jnp.float32),
                        features=jnp.asarray(feats), valid=jnp.asarray(valid))
    pf = mp.TensorField(coordinates=_t(coords).float(), features=_t(feats),
                        valid=_t(valid))
    jm, pm = mt.nn.Linear(out_channels=3), mp.nn.Linear(8, 3)
    v = _carry(jm, pm, rng, jf)
    np.testing.assert_allclose(_np(pm(pf).features),
                               np.asarray(jm.apply(v, jf).features), **TOL)


def test_origin_grid_and_hybrid_offsets_match_jax(rng):
    jst, pst = _tensors(stride=4)
    jo, po = mt.ops.origin_grid(jst.grid), mp.ops.origin_grid(pst.grid)
    np.testing.assert_array_equal(_np(po.coords), np.asarray(jo.coords))
    np.testing.assert_array_equal(_np(po.valid), np.asarray(jo.valid))
    assert po.stride == tuple(jo.stride) and po.batch_size == jo.batch_size
    cube, cross = mp.ops.RegionType.HYPER_CUBE, mp.ops.RegionType.HYPER_CROSS
    jcube, jcross = jkernels.RegionType.HYPER_CUBE, \
        jkernels.RegionType.HYPER_CROSS
    for ks, types, dil in ((3, (0, 1, 0), 1), ((3, 5, 3), (1, 1, 0), 2),
                           (2, (0, 0, 1), 1), (5, (1, 1, 1), 1)):
        got = mp.ops.hybrid_region_offsets(
            ks, [(cube, cross)[t] for t in types], dil)
        ref = mt.ops.hybrid_region_offsets(
            ks, [(jcube, jcross)[t] for t in types], dil)
        np.testing.assert_array_equal(got, ref)


def test_dense_conv_switch_routes_as_jax(rng, monkeypatch):
    assert pdense.DENSE_CONV_ENABLED is jdense.DENSE_CONV_ENABLED is False
    assert pdense.DENSE_NO_GROWTH is jdense.DENSE_NO_GROWTH is True
    cases = []
    for ext, bsz, stride, ks, st, cin, cout in (
            (16, 2, 1, 3, 1, 4, 8), (64, 4, 1, 3, 1, 4, 8),
            (64, 4, 1, 3, 1, 256, 8), (32, 2, 2, 3, 2, 4, 4),
            (32, 2, 1, 2, 1, 4, 4), (256, 4, 1, 3, 1, 8, 8),
            (256, 4, 1, 5, 1, 8, 64)):
        grid_kw = dict(stride=(stride,) * 3, batch_size=bsz,
                       extent=(ext,) * 3)
        pg = mp.ops.SparseGrid(coords=torch.zeros((64, 4), dtype=torch.int32),
                               valid=torch.zeros(64, dtype=torch.bool),
                               **grid_kw)
        jg = mt.ops.SparseGrid(coords=jnp.zeros((64, 4), jnp.int32),
                               valid=jnp.zeros(64, bool), **grid_kw)
        cases.append((mp.ops.KernelSpec(ks, st), mt.ops.KernelSpec(ks, st),
                      pg, jg, cin, cout))
    for flag in (False, True):
        mp.ops.enable_dense_conv(flag)
        mt.ops.enable_dense_conv(flag)
        try:
            got = [pdense.dense_conv_applicable(ps, pg, ci, co)
                   for ps, _, pg, _, ci, co in cases]
            ref = [jdense.dense_conv_applicable(js, jg, ci, co)
                   for _, js, _, jg, ci, co in cases]
            assert got == ref
            assert any(got) == flag
        finally:
            mp.ops.enable_dense_conv(False)
            mt.ops.enable_dense_conv(False)
    jst, pst = _tensors(cap=512, ext=12)
    jconv = mt.nn.SparseConv(out_channels=4)
    pconv = mp.nn.SparseConv(8, 4)
    v = _carry(jconv, pconv, rng, jst)
    mt.ops.enable_dense_conv(True)
    try:
        ref = jax.jit(lambda v, x: jconv.apply(v, x).features)(v, jst)
    finally:
        mt.ops.enable_dense_conv(False)
    for fused, dense, branch in ((None, False, "fused"), (None, True, "fused"),
                                 (False, True, "dense"),
                                 (False, False, "plain")):
        mp.ops.use_onehot_conv(fused)
        mp.ops.enable_dense_conv(dense)
        try:
            with mp.nn.record_routes() as routes:
                out = pconv(pst)
        finally:
            mp.ops.use_onehot_conv(None)
            mp.ops.enable_dense_conv(False)
        assert [r.branch for r in routes] == [branch]
        np.testing.assert_allclose(_np(out.features), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
    mp.ops.enable_dense_no_growth(False)
    try:
        assert not pdense.dense_no_growth_preferred(
            mp.ops.KernelSpec(3, 1), pst.grid.__class__(
                coords=pst.grid.coords, valid=pst.grid.valid,
                batch_size=1, extent=(2, 2, 2)))
    finally:
        mp.ops.enable_dense_no_growth(True)
