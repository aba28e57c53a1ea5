"""Tiny versions of the benchmark's cells, for the CPU tests."""

import copy

LOOSE = 1e9
TRAIN_LIMITS = {"loss1_gap": LOOSE, "grad1_gap": LOOSE, "change_gap": LOOSE}
GEN_LIMITS = {"chain_gap": LOOSE, "set_gap": LOOSE, "latent_gap": LOOSE,
              "eps_gap": LOOSE, "logit_gap": LOOSE, "step_gap": LOOSE,
              "set_mismatch": 0}

VAE = {"cell": {"name": "tiny.vae", "chips": 1},
       "config": {"vae_channels": [8, 16, 32, 32, 4],
                  "train": {"lr": 1e-3, "kld_weight": 1e-6}},
       "mix": {"entry": "train_vae", "sample": "shapes", "resolution": 32,
               "max_voxels": 300, "min_share": 0.5, "points_per_area": 10.0,
               "per_batch": 4, "max_batch_len": 1000, "capacity": 1024,
               "latent_rows": 64, "batches": 3, "pool_seed": 0},
       "limits": dict(TRAIN_LIMITS, lost_cells=0, choice_gap=LOOSE)}
# the 8^i buffers of MinkUNet at 16,384 input rows hold every cell of
# these rooms (1,800 voxels; 2,048 rows at stride 2, the floor of 64 from
# stride 8 on)
SEG = {"cell": {"name": "tiny.seg", "chips": 1},
       "config": {"model": "MinkUNet14", "in_channels": 3, "init_dim": 8,
                  "planes": [8, 8, 16, 16, 16, 16, 8, 8], "layers": [1] * 8,
                  "out_channels": 3, "train": {"lr": 1e-3}},
       "mix": {"entry": "train_seg", "sample": "rooms", "extent": 48,
               "footprint_voxels": [20, 30], "height_voxels": [12, 16],
               "room_voxels": 900, "per_batch": 2, "capacity": 16384,
               "batches": 3, "pool_seed": 0},
       "limits": TRAIN_LIMITS}
GEN = {"cell": {"name": "tiny.gen", "chips": 1},
       "config": {"vae_channels": [8, 16, 32, 32, 4],
                  "unet_channels": [4, 16, 32, 48], "group": 4,
                  "vae_scale": 0.1428, "sample_steps": 12},
       "mix": {"entry": "generate", "sample": "shapes", "resolution": 64,
               "max_voxels": 1500, "min_share": 0.5, "points_per_area": 10.0,
               "per_batch": 3, "capacity": 4096, "batches": 2,
               "pool_seed": 0},
       "limits": GEN_LIMITS}
CELLS = {"vae": VAE, "seg": SEG, "gen": GEN}
BENCH = {"end_to_end": [
    {"name": "train_points_per_s", "unit": "points/s",
     "workloads": ["tiny.vae", "tiny.seg"]},
    {"name": "train_step_p95_s", "unit": "s",
     "workloads": ["tiny.vae", "tiny.seg"]},
    {"name": "gen_shapes_per_s", "unit": "shapes/s",
     "workloads": ["tiny.gen"]},
    {"name": "peak_mem_gib", "unit": "GiB"},
    {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": n, "unit": u} for n, u in (
        ("host_enqueue_ms.train", "ms"), ("mfu.train", "%"),
        ("fused_conv_roofline.train", "%"), ("device_idle_share.train", "%"),
        ("denoise_step_ms.gen", "ms"), ("encode_decode_ms.gen", "ms"),
        ("mfu.gen", "%"), ("fused_conv_roofline.gen", "%"))]}


def spec(kind: str, **limits) -> dict:
    s = copy.deepcopy(CELLS[kind])
    s["limits"].update(limits)
    return s
