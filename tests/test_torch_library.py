"""The port's kernels as ``torch.library`` operators (`ops/library.py`), on
the CPU at tiny shapes (no JAX).

- ``torch.library.opcheck`` on every operator of ``mink_torch``: its
  schema, its autograd registration, its fake implementation against the
  CPU one, and its dispatch under ``aot_autograd`` with dynamic shapes.
- Each operator's CPU output equals, bit for bit, the plain version it
  wraps on the same operands.
- The gradients that the fused conv and the brick conv get through
  ``register_autograd`` equal, bit for bit, the formulas of the autograd
  Functions they replace (JAX's custom VJPs): dF and dW of the fused conv
  from the plain versions of B2 and B3 on the flipped and the forward
  geometry, and those of the brick conv from the plain dF pass and B6 on
  the cotangent volume.
"""

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp
from mink_octtree_stablediffusion_tpu_torch.ops import fused_conv as fc
from mink_octtree_stablediffusion_tpu_torch.ops import library
from mink_octtree_stablediffusion_tpu_torch.ops import onehot_conv as oc
from mink_octtree_stablediffusion_tpu_torch.ops import pallas_conv as pc
from mink_octtree_stablediffusion_tpu_torch.ops import vol_conv as vc

OPS = torch.ops.mink_torch
CD = torch.float32


def _grid(seed=0, n=40, cap=64, ext=8, bsz=2, stride=1):
    rng = np.random.RandomState(seed)
    coords = []
    for b in range(bsz):
        c = np.unique(rng.randint(0, ext, (n, 3)), axis=0)
        coords.append(np.concatenate([np.full((len(c), 1), b, np.int32), c],
                                     1))
    cpad, valid = mp.ops.pad_to_capacity(np.concatenate(coords), cap)
    g = mp.sparse_tensor(torch.as_tensor(cpad), torch.zeros(cap, 1),
                         capacity=cap, valid=torch.as_tensor(valid),
                         batch_size=bsz, extent=(ext,) * 3).grid
    return mp.ops.stride_grid(g, stride, cap) if stride > 1 else g


def _rand(seed, *shape, mask=None):
    t = torch.as_tensor(np.random.RandomState(seed).randn(*shape)
                        .astype(np.float32))
    return t if mask is None else t * mask[:, None].float()


def _fused_case(cin=3, cout=5, grad=True):
    """(args of ``fused_conv`` on a k3 s2 conv, its grids and geometry)."""
    gi = _grid()
    go = mp.ops.stride_grid(gi, 2, 32)
    spec = mp.ops.KernelSpec(3, 2, ndim=3)
    offs, s_in, cells = fc.conv_geometry(gi, spec)
    f = _rand(1, gi.capacity, cin, mask=gi.valid).requires_grad_(grad)
    k = (_rand(2, 27, cin, cout) * 0.2).requires_grad_(grad)
    args = (f, k, gi.flat_keys(), gi.coords, gi.valid, go.flat_keys(),
            go.coords, go.valid, fc._flat(offs), list(s_in), [8, 8, 8],
            list(go.stride), [8, 8, 8], CD)
    return args, gi, go, offs, s_in, cells


def _brick_case(cin=4, cout=6, grad=True):
    g = _grid(n=60, ext=8)
    cells = [8, 8, 8]
    f = _rand(3, g.capacity, cin, mask=g.valid).requires_grad_(grad)
    k = (_rand(4, 27, cin, cout) * 0.2).requires_grad_(grad)
    return (f, k, g.coords, g.valid, g.batch_size, [1, 1, 1], cells, CD), g


def _map_case():
    g = _grid()
    nbr = mp.ops.kernel_map(g, g, mp.ops.KernelSpec(3, 1, ndim=3))
    return (_rand(5, g.capacity, 4, mask=g.valid), _rand(6, 27, 4, 3) * 0.2,
            nbr)


def _cases():
    """operator → (args, its plain version's output on the same args)."""
    fa, gi, go, offs, s_in, cells = _fused_case(grad=False)
    f, k = fa[0], fa[1]
    g_out = _rand(7, go.capacity, 5, mask=go.valid)
    f_offs, s_out, c_out = fc.flipped_geometry(go, offs)
    geo = (fc._flat(offs), list(s_in), list(cells), CD)
    ba, bg = _brick_case(grad=False)
    volp = vc._scatter(ba[0], bg, ba[6], CD)
    gvolp = vc._scatter(_rand(8, bg.capacity, 6, mask=bg.valid), bg, ba[6],
                        CD)
    mf, mk, nbr = _map_case()
    plain_brick = vc._gather(vc._vol_conv_plain(volp, ba[1]), bg, ba[6])
    return {
        "fused_conv": (fa, fc._fused_sparse_conv_plain(
            f, k, gi.flat_keys(), go.coords, go.valid, offs, s_in, cells,
            CD)),
        "fused_conv_dfeatures": (
            (g_out, k, go.flat_keys(), gi.coords, gi.valid,
             fc._flat(f_offs), list(s_out), list(c_out), CD),
            fc._fused_sparse_conv_plain(g_out, k.transpose(1, 2),
                                        go.flat_keys(), gi.coords, gi.valid,
                                        f_offs, s_out, c_out, CD)),
        "fused_conv_dkernel": (
            (f, g_out, gi.flat_keys(), go.coords, go.valid) + geo,
            fc._dkernel_plain(f, g_out, gi.flat_keys(), go.coords, go.valid,
                              offs, s_in, cells, CD)),
        "fused_conv_stage": (
            (f, k, gi.flat_keys(), go.coords, go.valid) + geo + ("gather",),
            fc._stage_plain(f, k, gi.flat_keys(), go.coords, go.valid, offs,
                            s_in, cells, CD, "gather")),
        "brick_conv": (ba, (plain_brick, volp)),
        "vol_conv_tiles": ((volp, ba[1]), vc._vol_conv_plain(volp, ba[1])),
        "vol_conv_dfeatures": ((gvolp, ba[1]), vc._vol_conv_plain(
            gvolp, ba[1], mirror=True)),
        "vol_conv_dw": ((volp, gvolp, 4, 6),
                        vc._vol_conv_dw_plain(volp, gvolp, 4, 6)),
        "onehot_sparse_conv": ((mf, mk, nbr, torch.bfloat16),
                               oc.map_conv_plain(mf, mk, nbr,
                                                 torch.bfloat16)),
        "pallas_sparse_conv": ((mf, mk, nbr),
                               oc.map_conv_plain(mf, mk, nbr, CD)),
    }


def test_every_operator_has_a_case():
    assert set(_cases()) == set(library.OPS)


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    """Schema, autograd registration, fake vs CPU and aot dispatch."""
    args, _ = _cases()[name]
    if name in ("fused_conv", "brick_conv", "onehot_sparse_conv"):
        args = (args[0].detach().requires_grad_(),
                args[1].detach().requires_grad_()) + tuple(args[2:])
    torch.library.opcheck(getattr(OPS, name).default, args)


@pytest.mark.parametrize("name", library.OPS)
def test_cpu_output_is_the_plain_version(name):
    args, ref = _cases()[name]
    got = getattr(OPS, name)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fused_conv_gradient_is_the_vjp_formula():
    args, gi, go, offs, s_in, cells = _fused_case()
    f, k = args[0], args[1]
    g_out = _rand(9, go.capacity, 5, mask=go.valid)
    out = mp.ops.fused_sparse_conv(f, k, gi, go,
                                   mp.ops.KernelSpec(3, 2, ndim=3))
    out.backward(g_out)
    f_offs, s_out, c_out = fc.flipped_geometry(go, offs)
    df = fc._fused_sparse_conv_plain(g_out, k.detach().transpose(1, 2),
                                     go.flat_keys(), gi.coords, gi.valid,
                                     f_offs, s_out, c_out, CD)
    dk = fc._dkernel_plain(f.detach(), g_out, gi.flat_keys(), go.coords,
                           go.valid, offs, s_in, cells, CD)
    assert torch.equal(f.grad, df) and torch.equal(k.grad, dk)


def test_brick_conv_gradient_is_the_vjp_formula():
    args, g = _brick_case()
    f, k, cells = args[0], args[1], args[6]
    g_rows = _rand(10, g.capacity, 6, mask=g.valid)
    mp.ops.brick_pallas_conv(f, k, g, compute_dtype=CD).backward(g_rows)
    volp = vc._scatter(f.detach(), g, cells, CD)
    gvolp = vc._scatter(g_rows, g, cells, CD)
    df = vc._gather(vc._vol_conv_plain(gvolp, k.detach(), mirror=True), g,
                    cells)
    dk = vc._vol_conv_dw_plain(volp, gvolp, 4, 6)
    assert torch.equal(f.grad, df) and torch.equal(k.grad, dk)


def test_cpu_operators_count_no_launch():
    counters = (fc.fused_sparse_conv, fc.fused_conv_dfeatures,
                fc.fused_conv_dkernel, fc.fused_conv_stage,
                vc.vol_conv_tiles, vc.vol_conv_dfeatures, vc.vol_conv_dw,
                oc.onehot_sparse_conv,
                pc.pallas_sparse_conv)
    before = [c.launches for c in counters]
    for name, (args, _) in _cases().items():
        getattr(OPS, name)(*args)
    assert [c.launches for c in counters] == before
