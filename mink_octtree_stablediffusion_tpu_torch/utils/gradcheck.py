"""Numeric gradient verification (port of
`mink_octtree_stablediffusion_tpu/utils/gradcheck.py`; the reference's
`utils/gradcheck.py:34-60` wraps ``torch.autograd.gradcheck``)."""

from __future__ import annotations

import torch


def gradcheck(fn, args, order: int = 1, atol: float = 1e-2,
              rtol: float = 1e-2, eps: float = 1e-3) -> bool:
    """True if the analytic gradients of ``fn(*args)`` (``order`` 1) or
    its gradients of gradients (``order`` 2) match finite differences.
    Floating-point arguments are promoted to float64 and differentiated;
    the others pass as they are.  A mismatch raises."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    inputs = tuple(
        a.detach().to(torch.float64).requires_grad_(True)
        if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args)
    check = (torch.autograd.gradcheck if order == 1
             else torch.autograd.gradgradcheck)
    return bool(check(fn, inputs, eps=eps, atol=atol, rtol=rtol,
                      raise_exception=True))
