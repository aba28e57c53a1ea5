"""Serving: the generation program as one callable, and as an exported
artifact.

Port of `mink_octtree_stablediffusion_tpu/serve.py`.  ``build_generate_fn``:
encode the conditioning sample's geometry with the VAE encoder to fix the
latent coordinate set, denoise pure N(0,1) features with the UNet and the
scheduler, decode with the pruning decoder, and return the generated
stride-1 voxel set.  ``export_generate`` / ``load_generate`` /
``save_artifact`` / ``load_artifact`` serialise that whole program once
(``torch.export`` in place of ``jax.export``; the kernels are operators of
``ops/library.py``, so the graph holds them as calls), with the weights as
inputs, not constants: one artifact serves any checkpoint of matching
shapes, and a serving worker loads it and never runs the model's Python.
The noise of a request (JAX's ``key``) is an input too, drawn by
``load_artifact`` from a seeded ``torch.Generator``.  An artifact runs on
the device it was exported for (the card by default), never elsewhere.

``generation_models`` builds the configuration of `examples/generate.py`
(VAE with the `capacities()` schedule of `examples/train_vae.py`, UNet with
the latent-derived ``attn_max_len`` and down capacities) from the port's
own initialisers, and the conditioned, canvas configuration of
`scripts/cond_control.py` and `scripts/e2e_generalize.py` with their flags.
Template-free sampling on the canvas is composed as those scripts compose
it: ``ops.canvas_grid``, ``diffusion.sample_latent`` on a zero template,
then ``VAE.decode``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .diffusion.module import _needs_step_noise, sample_latent
from .models.unet import UNet
from .models.vae import VAE
from .tensor import sparse_tensor
from .utils import profiling
from .utils.device import make_generator, resolve_device


def capacities(input_capacity: int):
    """Per-level capacity schedule (`examples/train_vae.py::capacities`):
    encoder levels shrink ~4x per octree level (surface scaling), decoder
    candidate buffers carry 2x growth slack → (encoder, decoder)."""
    c = input_capacity
    enc = tuple(max(c // d, 128) for d in (2, 4, 16)) + \
        (max(c // 16, 128),) * 2
    dec = tuple(max(c // d, 128) for d in (16, 4, 2)) + (2 * c,)
    return enc, dec


def generation_models(*, input_capacity: int, batch_size: int,
                      vae_channel: Sequence[int] = (32, 128, 512, 512, 4),
                      unet_channel: Sequence[int] = (4, 320, 640, 960),
                      group: int = 32, attn_max_len: int = 0,
                      time_embedding_norm: str = "default",
                      max_keep: Optional[int] = None,
                      attn_window: Optional[int] = None,
                      with_cross_attn: bool = False,
                      cross_attention_dim: int = 768,
                      cond_into_time: bool = False,
                      with_window_attn: bool = False,
                      latent_canvas: bool = False, resolution: int = 128,
                      remat: bool = False, device=None, seed: int = 0):
    """(vae, unet) of `examples/generate.py`'s configuration (and of
    `examples/train_diffusion.py`'s), with weights from the port's
    initialisers and a seeded generator on ``device``.  ``max_keep`` is
    the decoder's per-level top-k clamp (`VAE.max_keep`).

    The UNet flags ``attn_window``, ``with_cross_attn``,
    ``cross_attention_dim``, ``cond_into_time`` and ``remat`` and the VAE
    flags ``with_window_attn`` and ``latent_canvas`` pass through.  With
    ``latent_canvas`` the sizes follow the dense stride-8 canvas of
    ``resolution``, as `scripts/e2e_generalize.py` and
    `scripts/cond_control.py` size them: the decoder's level 0 holds at
    least ``batch_size`` canvases, the UNet's down capacities are the
    canvas's dense bounds at strides 16, 32 and 64, and the default
    ``attn_max_len`` covers one canvas."""
    enc_caps, dec_caps = capacities(input_capacity)
    latent_cap = enc_caps[2]
    if latent_canvas:
        cells = (-(-resolution // 8)) ** 3
        dec_caps = (max(dec_caps[0], batch_size * cells),) + dec_caps[1:]
        attn_max_len = attn_max_len or max(-(-cells // 128) * 128, 128)
        down_caps = (max(batch_size * cells // 8, 16),
                     max(batch_size * cells // 64, 8),
                     max(batch_size * cells // 512, 8))
    else:
        attn_max_len = attn_max_len or max(
            -(-latent_cap * 3 // (2 * batch_size) // 128) * 128, 128)
        down_caps = (max(latent_cap // 2, 16), max(latent_cap // 4, 8),
                     max(latent_cap // 8, 8))
    vae = VAE(channels=tuple(vae_channel), encoder_capacities=enc_caps,
              decoder_capacities=dec_caps, max_keep=max_keep,
              with_window_attn=with_window_attn, latent_canvas=latent_canvas,
              device=device, seed=seed)
    unet = UNet(channels=tuple(unet_channel), group=group,
                attn_max_len=attn_max_len, attn_window=attn_window,
                time_embedding_norm=time_embedding_norm,
                with_cross_attn=with_cross_attn,
                cross_attention_dim=cross_attention_dim,
                cond_into_time=cond_into_time, down_capacities=down_caps,
                remat=remat, device=device, seed=seed + 1)
    return vae, unet


class GenerationProgram(torch.nn.Module):
    """The generation program of `serve.py::build_generate_fn` on tensors:
    ``forward(cpad, valid, init_noise=None, step_noises=None,
    encoder_hidden_state=None, generator=None) -> (coords, valid)``.  It
    encodes the conditioning voxels (``cpad`` int32 [input_capacity, 4],
    ``valid`` bool [input_capacity]) to fix the latent coordinate set,
    denoises N(0,1) features with the UNet and the scheduler, and decodes
    with the pruning decoder.  The noise is given, or drawn from
    ``generator`` (``sample_latent``).  Profiling spans (``utils.
    profiling``): ``serve.generate`` around a request, with
    ``serve.encode``, the sampler's and ``serve.decode`` inside it."""

    def __init__(self, vae: VAE, unet: UNet, scheduler, *,
                 input_capacity: int, batch_size: int, resolution: int,
                 vae_scale: float, sample_steps: int, steps_offset: int,
                 guidance_scale: float):
        super().__init__()
        self.vae, self.unet, self.scheduler = vae, unet, scheduler
        self.input_capacity, self.batch_size = input_capacity, batch_size
        self.resolution, self.vae_scale = resolution, vae_scale
        self.sample_steps, self.steps_offset = sample_steps, steps_offset
        self.guidance_scale = guidance_scale

    def latent(self, cpad: torch.Tensor, valid: torch.Tensor):
        """(the input sparse tensor, the scaled latent template)."""
        with profiling.span("serve.encode"):
            feats = torch.ones((self.input_capacity, 1),
                               device=cpad.device) * valid[:, None]
            st = sparse_tensor(cpad, feats, capacity=self.input_capacity,
                               batch_size=self.batch_size, valid=valid,
                               extent=(self.resolution,) * 3)
            mean, _ = self.vae.encode(st)
            return st, mean.with_features(mean.features * self.vae_scale)

    def forward(self, cpad, valid, init_noise=None, step_noises=None,
                encoder_hidden_state=None, generator=None):
        with profiling.span("serve.generate"):
            st, latent = self.latent(cpad, valid)
            z = sample_latent(self.unet, self.scheduler, latent,
                              num_inference_steps=self.sample_steps,
                              encoder_hidden_state=encoder_hidden_state,
                              guidance_scale=self.guidance_scale,
                              steps_offset=self.steps_offset,
                              generator=generator, init_noise=init_noise,
                              step_noises=step_noises)
            z = z.with_features(z.features / self.vae_scale)
            with profiling.span("serve.decode"):
                _, _, sout = self.vae.decode(z, st.grid)
            return sout.grid.coords, sout.grid.valid


def build_generate_fn(vae: VAE, unet: UNet, scheduler, *,
                      input_capacity: int, batch_size: int, resolution: int,
                      vae_scale: float = 0.1428, sample_steps: int = 64,
                      steps_offset: int = 0, guidance_scale: float = 1.0,
                      device=None) -> Callable:
    """``fn(cpad, valid, generator=None, init_noise=None, step_noises=None,
    encoder_hidden_state=None) -> (coords, valid)`` on ``device`` (default
    ``cuda``): ``cpad`` int32 [input_capacity, 4] and ``valid`` bool
    [input_capacity] (numpy or tensors) give the conditioning voxels.
    ``fn.program`` is its ``GenerationProgram``, ``fn.device`` the device;
    ``export_generate`` exports it."""
    dev = resolve_device(device)
    vae.eval()
    unet.eval()
    program = GenerationProgram(
        vae, unet, scheduler, input_capacity=input_capacity,
        batch_size=batch_size, resolution=resolution, vae_scale=vae_scale,
        sample_steps=sample_steps, steps_offset=steps_offset,
        guidance_scale=guidance_scale)

    @torch.no_grad()
    def fn(cpad, valid, generator: Optional[torch.Generator] = None,
           init_noise: Optional[torch.Tensor] = None,
           step_noises=None, encoder_hidden_state=None):
        return program(*_inputs(cpad, valid, dev), init_noise=init_noise,
                       step_noises=step_noises,
                       encoder_hidden_state=encoder_hidden_state,
                       generator=generator)

    fn.program, fn.device = program, dev
    return fn


def _inputs(cpad, valid, dev) -> tuple:
    """The conditioning voxels as int32 and bool tensors on ``dev``."""
    return (torch.as_tensor(np.asarray(cpad, np.int32), device=dev),
            torch.as_tensor(np.asarray(valid, bool), device=dev))


# -- the exported program (`jax.export`'s counterpart: `torch.export`) -------

PROGRAM, VAE_STATE, UNET_STATE, META = ("program.pt2", "vae_state.pt",
                                        "unet_state.pt", "meta.json")


class _Exported(torch.nn.Module):
    """The program with its weights as inputs: ``forward(vae_state,
    unet_state, cpad, valid, init_noise, step_noises)`` swaps the state
    dicts into the models for the call (``torch.func.functional_call``).
    The program is held outside the module's registry, so the exported
    graph lifts none of its parameters.  ``step_noises`` has 0 steps where
    the scheduler draws none (DDIM with eta 0)."""

    def __init__(self, program: GenerationProgram):
        super().__init__()
        self._program = (program,)

    def forward(self, vae_state, unet_state, cpad, valid, init_noise,
                step_noises):
        state = {**{f"vae.{k}": v for k, v in vae_state.items()},
                 **{f"unet.{k}": v for k, v in unet_state.items()}}
        return torch.func.functional_call(
            self._program[0], state, (cpad, valid, init_noise,
                                      step_noises if len(step_noises)
                                      else None))


def noise_spec(fn, cpad, valid) -> dict:
    """The noise a request of ``fn`` draws: the latent features' shape,
    the steps and whether each step draws (DDPM, or DDIM with eta > 0)."""
    program = fn.program
    with torch.no_grad():
        _, latent = program.latent(*_inputs(cpad, valid, fn.device))
    return {"shape": list(latent.features.shape),
            "steps": program.sample_steps,
            "step_noise": _needs_step_noise(program.scheduler)}


def draw_noise(spec: dict, generator: torch.Generator, device) -> tuple:
    """(init_noise, step_noises) from ``generator`` in ``sample_latent``'s
    order: the initial features, then one draw a step where the scheduler
    draws; ``step_noises`` [steps or 0, *shape]."""
    shape = tuple(spec["shape"])
    init = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)
    steps = spec["steps"] if spec["step_noise"] else 0
    draws = [torch.randn(shape, generator=generator, dtype=torch.float32,
                         device=device) for _ in range(steps)]
    return init, (torch.stack(draws) if draws else
                  torch.zeros((0,) + shape, device=device))


def export_program(fn, vae_state: dict, unet_state: dict, cpad, valid):
    """The generation program of ``fn`` (``build_generate_fn``) exported
    with ``torch.export`` (non-strict) for its device and the shapes of
    ``cpad`` and ``valid``: an ``ExportedProgram`` whose inputs are
    ``(vae_state, unet_state, cpad, valid, init_noise, step_noises)``.
    The example inputs that traced it (the weights among them) are not
    kept, so that a saved program holds no weight."""
    dev = fn.device
    cpad_t, valid_t = _inputs(cpad, valid, dev)
    init, steps = draw_noise(noise_spec(fn, cpad, valid),
                             torch.Generator(dev), dev)
    with torch.no_grad():
        ep = torch.export.export(
            _Exported(fn.program), (vae_state, unet_state, cpad_t, valid_t,
                                    init, steps), strict=False)
    ep.example_inputs = None
    return ep


def serialize(program) -> bytes:
    """An ``ExportedProgram`` as bytes (``torch.export.save``)."""
    import io

    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_generate(fn, vae_state: dict, unet_state: dict, cpad,
                    valid) -> bytes:
    """``export_program`` serialised to bytes.  The weights are inputs:
    the bytes hold the graph and no parameter."""
    return serialize(export_program(fn, vae_state, unet_state, cpad, valid))


def load_generate(data: bytes) -> Callable:
    """An exported generation program → ``call(vae_state, unet_state, cpad,
    valid, init_noise, step_noises) -> (coords, valid)`` on the tensors'
    device (the one it was exported for); ``call.exported`` is the
    ``ExportedProgram``."""
    import io

    exported = torch.export.load(io.BytesIO(data))
    module = exported.module()

    @torch.no_grad()
    def call(vae_state, unet_state, cpad, valid, init_noise, step_noises):
        return module(vae_state, unet_state, cpad, valid, init_noise,
                      step_noises)

    call.exported = exported  # the ExportedProgram, for inspection
    return call


def save_artifact(directory: str, fn, vae_state: dict, unet_state: dict,
                  example, program: Optional[bytes] = None) -> str:
    """Write a serving artifact: the exported program (``program.pt2``;
    ``program``, the bytes of ``export_generate``, where it was exported
    already), the two state dicts (``torch.save``), and ``meta.json`` (the
    device and the noise a request draws).  ``example`` = (cpad, valid)
    fixes the shapes."""
    import json
    import os

    os.makedirs(directory, exist_ok=True)
    cpad, valid = example
    if program is None:
        program = export_generate(fn, vae_state, unet_state, cpad, valid)
    with open(os.path.join(directory, PROGRAM), "wb") as f:
        f.write(program)
    torch.save(vae_state, os.path.join(directory, VAE_STATE))
    torch.save(unet_state, os.path.join(directory, UNET_STATE))
    meta = {"device": fn.device.type,
            "noise": noise_spec(fn, cpad, valid)}
    with open(os.path.join(directory, META), "w") as f:
        json.dump(meta, f)
    return directory


def load_artifact(directory: str, device=None) -> Callable:
    """A serving artifact → ``generate(cpad, valid, seed=0)`` returning
    numpy (coords, valid).  The artifact runs on the device type it was
    exported for (default: that one); asking for another, or for CUDA
    where there is none, raises.  The noise comes from
    ``torch.Generator(device).manual_seed(seed)`` in ``sample_latent``'s
    order, so a request equals ``build_generate_fn``'s ``fn(cpad, valid,
    generator=<the same seeded generator>)``.  ``generate.call`` is the
    loaded program (``load_generate``), ``generate.noise`` the noise a
    request draws (``draw_noise``), ``generate.device`` its device."""
    import json
    import os

    with open(os.path.join(directory, META)) as f:
        meta = json.load(f)
    dev = resolve_device(device if device is not None else meta["device"])
    if dev.type != meta["device"]:
        raise ValueError(f"the artifact runs on {meta['device']}, not on "
                         f"{dev.type}")
    with open(os.path.join(directory, PROGRAM), "rb") as f:
        call = load_generate(f.read())
    vae_state, unet_state = (
        torch.load(os.path.join(directory, name), map_location=dev,
                   weights_only=True) for name in (VAE_STATE, UNET_STATE))

    def generate(cpad, valid, seed: int = 0):
        init, steps = draw_noise(meta["noise"], make_generator(seed, dev),
                                 dev)
        coords, mask = call(vae_state, unet_state, *_inputs(cpad, valid, dev),
                            init, steps)
        return coords.cpu().numpy(), mask.cpu().numpy()

    generate.call, generate.noise, generate.device = call, meta["noise"], dev
    return generate
