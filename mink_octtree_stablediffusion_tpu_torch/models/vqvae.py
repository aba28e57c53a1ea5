"""VQ-VAE: the vector-quantized octree autoencoder.

Port of `VectorQuantizer` and `VQVAE` from
`mink_octtree_stablediffusion_tpu/models/vqvae.py`: the VAE's encoder and
pruning decoder around a codebook of ``num_embeddings`` codes (initialised
U(−1/K, 1/K)), nearest-code assignment by L2 distance, the straight-through
estimator ``ze + sg(zq − ze)`` and the commitment losses
``‖zq − sg(ze)‖² + ‖sg(zq) − ze‖²`` over the valid rows.  The argmin over
the codes is a plain matmul and ``argmin``, as JAX leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.init import init_parameters
from ..ops.coords import SparseGrid
from ..parallel.mesh import all_reduce_sum
from ..tensor import SparseTensor
from ..utils.device import make_generator, resolve_device
from .vae import Decoder, Encoder


EMA_EPS = 1e-5  # the Laplace smoothing of the EMA cluster sizes


class VectorQuantizer(nn.Module):
    """Nearest-code lookup + straight-through → (quantized tensor, code
    index per row, loss).

    The codebook-gradient form (default) holds the codebook as the
    parameter ``embedding`` and returns both commitment terms.  With
    ``ema=True`` the codebook is a buffer moved by exponential moving
    averages instead (van den Oord et al., App. A): ``embedding``,
    ``cluster_size``, ``ema_sum`` and ``steps`` are buffers (JAX's
    ``vq_stats`` collection), the loss is the encoder's commitment term
    only, and a step in ``.train()`` quantizes with the book from before
    its update, then updates it from the valid rows' assignments; in
    ``.eval()`` nothing moves.  ``restart_dead`` re-seeds every code whose
    EMA cluster size fell below ``dead_floor`` with a valid encoder row
    drawn uniformly from the batch: the draw comes from the ``generator``
    the caller passes (JAX draws from ``fold_in(PRNGKey(13), steps)``, a
    stream PyTorch cannot reproduce, so the two agree on which codes
    restart and on every other buffer, and on the rows only where the
    batch has one valid row).  With a ``process_group`` the per-code
    counts and sums are summed over its ranks before the update (JAX's
    ``axis_name``), so every rank moves its book alike."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 ema: bool = False, ema_decay: float = 0.99,
                 restart_dead: bool = False, dead_floor: float = 0.1,
                 process_group=None, device=None):
        super().__init__()
        k, d = num_embeddings, embedding_dim
        self.num_embeddings, self.embedding_dim = k, d
        self.ema, self.ema_decay = ema, ema_decay
        self.restart_dead, self.dead_floor = restart_dead, dead_floor
        self.process_group = process_group
        book = torch.empty(k, d, device=device)
        if ema:
            self.register_buffer("embedding", book)
            self.register_buffer("cluster_size",
                                 torch.ones(k, device=device))
            self.register_buffer("ema_sum", book.clone())
            self.register_buffer("steps", torch.zeros(
                (), dtype=torch.int32, device=device))
        else:
            self.embedding = nn.Parameter(book)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        k = self.num_embeddings
        with torch.no_grad():
            self.embedding.uniform_(-1.0 / k, 1.0 / k, generator=generator)
            if self.ema:
                self.cluster_size.fill_(1.0)
                self.ema_sum.copy_(self.embedding)
                self.steps.zero_()

    def forward(self, ze: SparseTensor,
                generator: Optional[torch.Generator] = None):
        book = self.embedding
        f = ze.features
        # ‖ze − e‖² = ‖ze‖² − 2 ze·e + ‖e‖²  (argmin over codes)
        d = ((f ** 2).sum(-1, keepdim=True) - 2.0 * f @ book.t() +
             (book ** 2).sum(-1)[None, :])
        return self.quantize(ze, d.argmin(dim=-1), generator)

    def quantize(self, ze: SparseTensor, idx: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        """``forward`` after the argmin: quantize ``ze`` with the code
        indices ``idx`` → (quantized tensor, ``idx``, loss)."""
        f = ze.features
        zq = self.embedding[idx]
        st = f + (zq - f).detach()  # the decoder's input carries ze's grad
        v = ze.valid.to(f.dtype)[:, None]
        denom = (v.sum() * self.embedding_dim).clamp(min=1.0)
        loss_ze = ((zq.detach() - f) ** 2 * v).sum() / denom
        if not self.ema:
            loss_zq = ((zq - f.detach()) ** 2 * v).sum() / denom
            return ze.with_features(st), idx, loss_zq + loss_ze
        if self.training:
            self._ema_update(f.detach(), idx, v, generator)
        return ze.with_features(st), idx, loss_ze

    @torch.no_grad()
    def _ema_update(self, zf, idx, v, generator) -> None:
        k = self.num_embeddings
        onehot = F.one_hot(idx, k).to(zf.dtype) * v  # invalid rows count 0
        counts, sums = onehot.sum(0), onehot.t() @ zf
        if self.process_group is not None:  # data parallel: global stats
            both = all_reduce_sum(torch.cat([counts[:, None], sums], 1),
                                  self.process_group)
            counts, sums = both[:, 0], both[:, 1:]
        dcy = self.ema_decay
        cs = dcy * self.cluster_size + (1 - dcy) * counts
        es = dcy * self.ema_sum + (1 - dcy) * sums
        n = cs.sum()
        cs_smoothed = (cs + EMA_EPS) / (n + k * EMA_EPS) * n
        book = es / cs_smoothed[:, None]
        if self.restart_dead:
            if generator is None:
                raise ValueError("restart_dead draws its rows from a "
                                 "generator: pass one in .train()")
            w = v[:, 0]
            # no valid row: every row is a zero padding row, any will do
            p = w if bool(w.sum() > 0) else torch.ones_like(w)
            rows = torch.multinomial(p, k, replacement=True,
                                     generator=generator)
            dead = cs < self.dead_floor
            book = torch.where(dead[:, None], zf[rows], book)
            es = torch.where(dead[:, None], zf[rows], es)
            cs = torch.where(dead, torch.ones_like(cs), cs)
        self.cluster_size.copy_(cs)
        self.ema_sum.copy_(es)
        self.embedding.copy_(book)
        self.steps.add_(1)


class VQVAE(nn.Module):
    """encoder → quantizer → pruning decoder.  ``forward(sinput,
    target_grid, generator=None)`` → (out_clss, targets, sout, ze, idx,
    vq_loss).  The encoder's log-variance head is not used (nor run): its
    parameters stay in the tree, as in JAX, where their gradient is zero.
    Random weights from ``seed``; a new model is in ``.eval()``."""

    def __init__(self, channels: Sequence[int] = (32, 128, 512, 512, 4),
                 num_embeddings: int = 512,
                 encoder_capacities: Sequence[int] = (16384, 8192, 2048,
                                                      2048, 2048),
                 decoder_capacities: Sequence[int] = (2048, 8192, 16384,
                                                      32768),
                 max_keep: Optional[int] = None, ema: bool = False,
                 ema_decay: float = 0.99, restart_dead: bool = False,
                 in_channels: int = 1, process_group=None, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        ch = tuple(channels)
        self.encoder = Encoder(ch, encoder_capacities, in_channels,
                               process_group=process_group, device=dev)
        self.decoder = Decoder(tuple(reversed(ch)), decoder_capacities,
                               max_keep, process_group, device=dev)
        self.vq = VectorQuantizer(num_embeddings, ch[-1], ema=ema,
                                  ema_decay=ema_decay,
                                  restart_dead=restart_dead,
                                  process_group=process_group, device=dev)
        init_parameters(self, make_generator(seed, dev))
        self.eval()

    def forward(self, sinput: SparseTensor, target_grid: SparseGrid,
                generator: Optional[torch.Generator] = None):
        ze = self.encoder.mean_conv(self.encoder.trunk(sinput))
        zq, idx, vq_loss = self.vq(ze, generator)
        out_clss, targets, sout = self.decoder(zq, target_grid)
        return out_clss, targets, sout, ze, idx, vq_loss
