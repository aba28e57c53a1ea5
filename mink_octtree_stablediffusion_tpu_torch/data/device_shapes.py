"""Procedural shapes synthesized on the device.

Port of `mink_octtree_stablediffusion_tpu/data/device_shapes.py`: the
parametric family of `ProceduralShapes` (sphere, torus, box, cylinder;
per-axis aspect, a random rotation, class parameters, and with probability
``composite_prob`` a union with a second, smaller same-class primitive at
a random offset) drawn with PyTorch ops on the caller's device from a
``torch.Generator`` there, then voxelized and packed by a sort-based dedup
into `collate_pointclouds`' layout.  A batch is device work queued ahead
of the step: nothing in `procedural_batch` waits for the device or copies
to the host.

The shapes are distribution-equivalent to the JAX package's, not equal:
a ``torch.Generator`` is another stream than ``jax.random``.  Given the
same draws, each primitive's geometry is the JAX function's.  Where JAX
evaluates all four primitives under ``vmap`` and selects one
(``lax.switch``), this module draws only the shape's own; the box's face
choice is ``torch.multinomial`` where JAX takes a categorical, and the
cylinder splits side from caps by a per-point Bernoulli, as JAX does.  The
rotation is the Q of a Householder QR of a Gaussian 3×3 with LAPACK's sign
convention (written out here, so that the card and the CPU agree), its
first column negated where its determinant is negative.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

CLASSES = ("sphere", "torus", "box", "cylinder")
I32_MAX = 2 ** 31 - 1


def _uniform(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def sphere(u, v):
    th = 2 * math.pi * u
    ph = torch.arccos(torch.clamp(2 * v - 1, -1.0, 1.0))
    return torch.stack([torch.sin(ph) * torch.cos(th),
                        torch.sin(ph) * torch.sin(th), torch.cos(ph)], -1)


def torus(u, v, r):
    big = 1.0 - r
    th, ph = 2 * math.pi * u, 2 * math.pi * v
    return torch.stack([(big + r * torch.cos(ph)) * torch.cos(th),
                        (big + r * torch.cos(ph)) * torch.sin(th),
                        r * torch.sin(ph)], -1)


def cylinder(u, v, h, sign, c):
    """A closed tube: a point lies on the side where ``c < 2h/(2h+1)`` (the
    side's share of the area), else on the cap of its ``sign``."""
    th = 2 * math.pi * u
    is_side = c < 2 * h / (2 * h + 1)
    side = torch.stack([torch.cos(th), torch.sin(th), h * (2 * v - 1)], -1)
    rr = torch.sqrt(v)
    caps = torch.stack([rr * torch.cos(th), rr * torch.sin(th),
                        sign.to(u.dtype) * h], -1)
    return torch.where(is_side[:, None], side, caps)


def box(half, face, p):
    """A cuboid's surface: ``p`` uniform in [-1, 1]³ pressed onto face
    ``face`` (axis ``face // 2``, side ``face % 2``), scaled by ``half``."""
    ax = face // 2
    sign = ((face % 2) * 2 - 1).to(p.dtype)
    onehot = torch.nn.functional.one_hot(ax, 3).to(p.dtype)
    p = p * (1 - onehot) + sign[:, None] * onehot
    return p * half[None, :]


def box_face_probs(half):
    areas = torch.stack([half[1] * half[2], half[0] * half[2],
                         half[0] * half[1]])
    return torch.repeat_interleave(areas / areas.sum() / 2.0, 2)


def householder_q(a):
    """Q of the Householder QR of a 3×3 ``a`` with LAPACK's convention
    (``geqrf``/``orgqr``: each reflector sends its column to
    ``-sign(alpha)·‖x‖``; the last column takes no reflector)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q, r = eye, a
    for j in range(2):
        x = r[j:, j]
        alpha, xnorm = x[0], torch.linalg.vector_norm(x[1:])
        beta = -torch.where(alpha >= 0, 1.0, -1.0).to(a.dtype) * \
            torch.sqrt(alpha * alpha + xnorm * xnorm)
        live = xnorm > 0
        safe_beta = torch.where(live, beta, torch.ones_like(beta))
        tau = torch.where(live, (safe_beta - alpha) / safe_beta, 0.0)
        denom = torch.where(live, alpha - beta, torch.ones_like(alpha))
        v = torch.cat([torch.ones_like(alpha)[None], x[1:] / denom])
        v = torch.cat([torch.zeros(j, dtype=a.dtype, device=a.device), v])
        h = eye - tau * torch.outer(v, v)
        r = h @ r
        q = q @ h
    return q


def det3(m):
    return (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
            - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
            + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))


def pose(p, aspect, gauss):
    """Per-axis ``aspect``, then the rotation of the Gaussian 3×3
    ``gauss``."""
    p = p * aspect[None, :]
    q = householder_q(gauss)
    flip = torch.where(det3(q) < 0, -1.0, 1.0).to(q.dtype)
    q = q * torch.stack([flip, torch.ones_like(flip),
                         torch.ones_like(flip)])[None, :]
    return p @ q.T


def _primitive(gen, label: int, n: int):
    """One aspect-scaled, randomly rotated primitive surface [n, 3]."""
    kind = CLASSES[label]
    if kind == "sphere":
        p = sphere(_uniform(gen, n), _uniform(gen, n))
    elif kind == "torus":
        u, v = _uniform(gen, n), _uniform(gen, n)
        p = torus(u, v, _uniform(gen, (), 0.12, 0.42))
    elif kind == "cylinder":
        u, v = _uniform(gen, n), _uniform(gen, n)
        h = _uniform(gen, (), 0.5, 1.3)
        sign = torch.randint(0, 2, (n,), generator=gen,
                             device=gen.device) * 2 - 1
        p = cylinder(u, v, h, sign, _uniform(gen, n))
    else:
        half = _uniform(gen, 3, 0.5, 1.0)
        face = torch.multinomial(box_face_probs(half), n, replacement=True,
                                 generator=gen)
        p = box(half, face, _uniform(gen, (n, 3), -1.0, 1.0))
    aspect = _uniform(gen, 3, 0.55, 1.0)
    gauss = torch.randn((3, 3), generator=gen, device=gen.device)
    return pose(p, aspect, gauss)


def sample_shape(gen: torch.Generator, label: int, n: int, resolution: int,
                 composite_prob: float = 0.25) -> torch.Tensor:
    """One shape's surface cloud [n, 3] on ``gen``'s device, scaled into
    [0, resolution).  Both primitives are drawn at n points; the
    composite's first ``floor(frac·n)`` points come from the first."""
    a = _primitive(gen, label, n)
    b = _primitive(gen, label, n)
    composite = _uniform(gen, ()) < composite_prob
    frac = _uniform(gen, (), 0.6, 0.8)
    scale = _uniform(gen, (), 0.35, 0.65)
    direction = torch.randn(3, generator=gen, device=gen.device)
    direction = direction / torch.clamp(torch.linalg.vector_norm(direction),
                                        min=1e-9)
    offset = direction * _uniform(gen, (), 0.6, 1.0)
    ar = torch.arange(n, device=gen.device)
    use_a = ar < (frac * n).to(torch.int32)
    xyz = torch.where((use_a | ~composite)[:, None], a, b * scale + offset)
    lo, hi = xyz.amin(0), xyz.amax(0)
    s = (resolution - 1.01) / torch.clamp((hi - lo).amax(), min=1e-9)
    return (xyz - lo) * s


def pack_voxels(vox: torch.Tensor, resolution: int, capacity: int):
    """``[b, n, 3]`` int32 voxels → (coords ``[capacity, 4]`` int32, valid
    ``[capacity]`` bool, feats ``[capacity, 1]`` float32): flat int32 keys
    (batch-major) → sort → first occurrences → sort again with the repeats
    at ``I32_MAX`` → the first ``capacity``.  Where the unique count
    overflows the capacity, the largest keys (the last instances' rows)
    drop.  Padding rows are all zero."""
    b, n, _ = vox.shape
    if b * resolution ** 3 >= I32_MAX:
        raise ValueError(f"{b} instances at resolution {resolution} "
                         "overflow the int32 flat key")
    dev = vox.device
    bidx = torch.arange(b, dtype=torch.int32,
                        device=dev).repeat_interleave(n)
    flat = vox.reshape(-1, 3).to(torch.int32)
    key = (((bidx * resolution + flat[:, 0]) * resolution + flat[:, 1])
           * resolution + flat[:, 2])
    s = torch.sort(key).values
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      s[1:] != s[:-1]])
    s2 = torch.sort(torch.where(uniq, s, I32_MAX)).values
    if capacity <= s2.shape[0]:
        take = s2[:capacity]
    else:
        take = torch.cat([s2, torch.full((capacity - s2.shape[0],), I32_MAX,
                                         dtype=torch.int32, device=dev)])
    valid = take < I32_MAX
    safe = torch.where(valid, take, 0)
    z = safe % resolution
    y = (safe // resolution) % resolution
    x = (safe // (resolution * resolution)) % resolution
    bi = safe // resolution ** 3
    cpad = torch.stack([bi, x, y, z], -1).to(torch.int32) * \
        valid[:, None].to(torch.int32)
    return cpad, valid, valid[:, None].to(torch.float32)


def procedural_batch(gen: torch.Generator, batch_size: int, points: int,
                     resolution: int, capacity: int,
                     composite_prob: float = 0.25,
                     labels: Optional[Sequence[int]] = None):
    """A fresh procedural batch on ``gen``'s device: (coords
    ``[capacity, 4]`` int32, valid ``[capacity]`` bool, feats
    ``[capacity, 1]`` float32, labels ``[batch_size]`` int32), the layout
    of the host `collate_pointclouds` path.  ``labels`` (host ints) default
    to ``i % 4``; each call advances ``gen``."""
    dev = gen.device
    if labels is None:
        host_labels = [i % len(CLASSES) for i in range(batch_size)]
        out_labels = torch.arange(batch_size, dtype=torch.int32,
                                  device=dev) % len(CLASSES)
    else:
        host_labels = [int(l) for l in labels]
        out_labels = torch.tensor(host_labels, dtype=torch.int32).to(
            dev, non_blocking=True)
    xyz = torch.stack([sample_shape(gen, l, points, resolution,
                                    composite_prob) for l in host_labels])
    vox = torch.clamp(torch.floor(xyz), 0, resolution - 1).to(torch.int32)
    cpad, valid, feats = pack_voxels(vox, resolution, capacity)
    return cpad, valid, feats, out_labels
