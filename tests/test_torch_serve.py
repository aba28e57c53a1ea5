"""The serving artifact of the port (`serve.py`: ``export_generate``,
``load_generate``, ``save_artifact``, ``load_artifact``) on the CPU, at
`tests/test_serve.py`'s tiny sizes (batch 2, capacity 256, resolution 16,
VAE (8, 12, 16, 16, 4), UNet (4, 8, 16, 16), group 4) with 1 DDIM step
(no JAX).

One artifact is written and loaded for the whole module (the export, the
save and the load each take tens of seconds here):

- (a) the loaded program's (coords, valid) equal ``build_generate_fn``'s
  direct call on the same noise, bit for bit;
- (b) ``load_artifact``'s ``generate(seed=7)`` equals ``fn(generator=
  seeded 7)``, bit for bit;
- (c) a second checkpoint (other initial weights) through the same program
  equals the direct call with those weights;
- (d) the program holds no parameter: its state dict is empty, it keeps
  no example inputs (the weights traced it), it lifts no parameter or
  buffer, no constant it holds has a weight's shape, and its constants
  hold under 1% of the weights' bytes;
- (e) the export runs the UNet's eager forward: no call of it engages a
  CUDA graph (``models.unet_graph.engages``; each sees a tracer's tensors
  or a tracing flag, so none would on the card either), and the UNet
  keeps no graph.
"""

import numpy as np
import pytest
import torch

import mink_octtree_stablediffusion_tpu_torch as mp

B, CAP, RES = 2, 256, 16


def _models(seed):
    vae = mp.models.VAE(channels=(8, 12, 16, 16, 4),
                        encoder_capacities=(128, 64, 32, 32, 32),
                        decoder_capacities=(32, 64, 128, 256), device="cpu",
                        seed=seed)
    unet = mp.models.UNet(channels=(4, 8, 16, 16), attn_max_len=32, group=4,
                          down_capacities=(16, 8, 8), device="cpu",
                          seed=seed + 1)
    return vae, unet


def _fn(vae, unet):
    return mp.serve.build_generate_fn(
        vae, unet, mp.diffusion.DDIMScheduler.create(), input_capacity=CAP,
        batch_size=B, resolution=RES, sample_steps=1, device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.RandomState(0)
    vox = [np.unique(rng.randint(0, RES, (40, 3)), axis=0) for _ in range(B)]
    cpad, valid = mp.ops.pad_to_capacity(mp.ops.batched_coordinates_np(vox),
                                         CAP)
    vae, unet = _models(0)
    fn = _fn(vae, unet)
    engages, seen = mp.models.unet.engages, []

    def spy(x, t):  # what the UNet's forward saw while it was exported
        seen.append((type(x.features) is torch.Tensor,
                     mp.models.unet_graph._tracing(), engages(x, t)))
        return seen[-1][2]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(mp.models.unet, "engages", spy)
        d = mp.serve.save_artifact(str(tmp_path_factory.mktemp("artifact")),
                                   fn, vae.state_dict(), unet.state_dict(),
                                   example=(cpad, valid))
    return {"fn": fn, "vae": vae, "unet": unet, "cpad": cpad,
            "valid": valid, "generate": mp.serve.load_artifact(d),
            "export_calls": seen}


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got[0]), ref[0].numpy())
    np.testing.assert_array_equal(np.asarray(got[1]), ref[1].numpy())


def test_loaded_program_equals_direct_call(served):
    s = served
    init, steps = mp.serve.draw_noise(s["generate"].noise,
                                      torch.Generator().manual_seed(3), "cpu")
    cpad, valid = (torch.as_tensor(s["cpad"]), torch.as_tensor(s["valid"]))
    got = s["generate"].call(s["vae"].state_dict(), s["unet"].state_dict(),
                             cpad, valid, init, steps)
    ref = s["fn"](s["cpad"], s["valid"], init_noise=init,
                  step_noises=steps if len(steps) else None)
    assert ref[1].sum() > 0
    _equal([t.numpy() for t in got], ref)


def test_load_artifact_seed_equals_seeded_generator(served):
    s = served
    coords, mask = s["generate"](s["cpad"], s["valid"], seed=7)
    ref = s["fn"](s["cpad"], s["valid"],
                  generator=torch.Generator().manual_seed(7))
    assert mask.sum() > 0
    _equal((coords, mask), ref)


def test_second_checkpoint_through_the_same_program(served):
    s = served
    vae2, unet2 = _models(5)
    init, steps = mp.serve.draw_noise(s["generate"].noise,
                                      torch.Generator().manual_seed(4), "cpu")
    got = s["generate"].call(vae2.state_dict(), unet2.state_dict(),
                             torch.as_tensor(s["cpad"]),
                             torch.as_tensor(s["valid"]), init, steps)
    ref = _fn(vae2, unet2)(s["cpad"], s["valid"], init_noise=init)
    first = s["fn"](s["cpad"], s["valid"], init_noise=init)
    assert not (torch.equal(ref[0], first[0]) and
                torch.equal(ref[1], first[1])), "the weights move nothing"
    _equal([t.numpy() for t in got], ref)


def test_program_holds_no_parameter(served):
    s = served
    ep = s["generate"].call.exported
    assert not ep.state_dict and ep.example_inputs is None
    sig = ep.graph_signature
    assert not sig.parameters and not sig.buffers
    shapes = {tuple(t.shape) for m in (s["vae"], s["unet"])
              for t in m.state_dict().values() if t.numel() > 1}
    held = [tuple(t.shape) for t in ep.constants.values()
            if isinstance(t, torch.Tensor)]
    assert not shapes & set(held), held
    weight_bytes = sum(t.numel() * t.element_size() for m in (
        s["vae"], s["unet"]) for t in m.state_dict().values())
    assert sum(t.numel() * t.element_size() for t in ep.constants.values()
               if isinstance(t, torch.Tensor)) < weight_bytes / 100


def test_export_runs_the_eager_unet_forward(served):
    calls = served["export_calls"]
    assert calls and not any(engaged for _, _, engaged in calls)
    assert all(tracing or not plain for plain, tracing, _ in calls)
    assert len(served["unet"].graphs.graphs) == 0
