"""One rank of tests/test_torch_parallel.py: joins a gloo process group on
the CPU, runs every sharded variant of sgrt_tpu_torch on the inputs that the
test wrote, and saves what each returns to OUT_DIR/rank<RANK>.npz (keys
"<case>__<name>"). Imports torch, numpy and sgrt_tpu_torch only.

    python tests/torch_parallel_worker.py RANK WORLD HOST:PORT INPUTS.npz OUT_DIR
"""

import dataclasses
import functools
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sgrt_tpu_torch.models.camera import Camera  # noqa: E402
from sgrt_tpu_torch.models.gaussians import scene_from_numpy  # noqa: E402
from sgrt_tpu_torch.ops.anisotropic import from_isotropic  # noqa: E402
from sgrt_tpu_torch.ops.cuda_chunked import MAX_MONOLITHIC_CAPACITY  # noqa: E402
from sgrt_tpu_torch.ops.frame import render_orbit_frame  # noqa: E402
from sgrt_tpu_torch.ops.scheduler import BucketConfig  # noqa: E402
from sgrt_tpu_torch.parallel.fit import (  # noqa: E402
    adam,
    fit,
    init_state,
    make_aniso_frame_train_step,
    make_frame_train_step,
    make_slab_frame_train_step,
    make_train_step,
)
from sgrt_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed,
    make_mesh,
    shard_rays,
)
from sgrt_tpu_torch.parallel.render import make_sharded_frame_renderer, render_sharded  # noqa: E402
from sgrt_tpu_torch.utils.checkpoint import restore_fit  # noqa: E402

FIELDS = ("mu", "sigma", "magnitude", "albedo")
FRAME = dict(width=32, height=32, tiles=4)
SGD1 = functools.partial(torch.optim.SGD, lr=1.0)


def main() -> int:
    rank, world, coord, inputs, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    initialize_distributed(coord, world, rank, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (rank, world), mesh
    x = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    res = {}

    def scene(prefix):
        return scene_from_numpy(*(x[f"{prefix}_{f}"] for f in FIELDS), device="cpu")

    def put(case, **vals):
        for k, v in vals.items():
            if dataclasses.is_dataclass(v):
                for f, t in vars(v).items():
                    res[f"{case}__{f}"] = t.detach().numpy()
            else:
                res[f"{case}__{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v)

    frame_in = (x["frame_view"], x["frame_o"], x["frame_dirs"], x["frame_target"])
    s = scene("scene")

    # 1. the ray-sharded untiled step
    step = make_train_step(mesh=mesh, q_block=8, ray_block=8)
    st = init_state(s, SGD1, mesh)
    st, loss = step(st, x["ray_o"], *shard_rays(mesh, x["ray_dirs"], x["ray_target"]))
    put("ray", loss=loss, scene=st.scene)

    # 2, 3, 6, 5, 7: the tile-sharded frame steps (dryrun_multichip's numbering)
    frame_steps = {
        "frame": (s, make_frame_train_step(capacity=8, mesh=mesh, **FRAME)),
        "bucketed": (s, make_frame_train_step(capacity=8, mesh=mesh,
                                              bucket_cfg=BucketConfig(2, 16, 8), **FRAME)),
        "chunked": (s, make_frame_train_step(capacity=MAX_MONOLITHIC_CAPACITY + 1, mesh=mesh,
                                             **FRAME)),
        "aniso": (from_isotropic(s), make_aniso_frame_train_step(capacity=8, mesh=mesh,
                                                                 **FRAME)),
        "slab": (s, make_slab_frame_train_step(capacity=8, slab_tiles=2, mesh=mesh, **FRAME)),
        "slab_aniso": (from_isotropic(s), make_slab_frame_train_step(
            capacity=8, slab_tiles=2, mesh=mesh, aniso=True, **FRAME)),
    }
    for case, (sc, step) in frame_steps.items():
        st, loss, overflow = step(init_state(sc, SGD1, mesh), *frame_in)
        put(case, loss=loss, overflow=overflow, scene=st.scene)

    # 4. the tile-sharded forward, and the sharded forward of
    # tests/test_parallel.py (grid_scene(3) at 30 degrees), single-capacity
    # and bucketed; each beside the one-device frame
    g3 = scene("fwd_scene")
    fwd_in = (x["fwd_view"], x["fwd_o"], x["fwd_dirs"])
    forwards = {"forward": (s, frame_in[:3], dict(capacity=8), 0.0),
                "fwd_single": (g3, fwd_in, dict(capacity=32), 30.0),
                "fwd_bucketed": (g3, fwd_in, dict(bucket_cfg=BucketConfig(8, 32, 16)), 30.0)}
    for case, (sc, inp, kw, angle) in forwards.items():
        img, overflow = make_sharded_frame_renderer(mesh, **FRAME, **kw)(sc, *inp)
        single, _ = render_orbit_frame(sc, angle, backend="kernel", **FRAME, **kw)
        put(case, image=img, overflow=overflow, single=single)

    # render_sharded: rows of pixels over the ranks
    cam = Camera.create(position=(0.0, 0.0, -4.0), width=8, height=16, device="cpu")
    img = render_sharded(s, cam, mesh, q_block=8, ray_block=16)
    put("render_sharded", image=img)

    # fit(mesh=...): rank 0 writes the checkpoints; every rank restores them
    ckpt = os.path.join(out, "ckpt")
    fitted, losses = fit(s, x["ray_o"], x["ray_dirs"], x["ray_target"], steps=3,
                         learning_rate=1e-2, mesh=mesh, q_block=8, ray_block=8,
                         checkpoint_dir=ckpt, checkpoint_every=2)
    restored = restore_fit(ckpt, init_state(s, adam(1e-2)))
    put("fit", loss=np.array(losses), scene=fitted, restored_step=restored.step)
    put("fit_restored", scene=restored.scene)

    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    loaded = [m for m in sys.modules if m in ("jax", "sgrt_tpu")
              or m.startswith(("jax.", "sgrt_tpu."))]
    assert not loaded, loaded
    return 0


if __name__ == "__main__":
    sys.exit(main())
