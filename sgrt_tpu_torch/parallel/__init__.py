from sgrt_tpu_torch.parallel.fit import (
    FitState,
    adam,
    fit,
    init_state,
    make_aniso_frame_train_step,
    make_frame_train_step,
    make_frame_value_and_grad,
    make_slab_frame_train_step,
    make_train_step,
)
from sgrt_tpu_torch.parallel.mesh import make_mesh, shard_rays
from sgrt_tpu_torch.parallel.render import render_sharded

__all__ = ["FitState", "adam", "fit", "init_state", "make_aniso_frame_train_step",
           "make_frame_train_step", "make_frame_value_and_grad", "make_mesh",
           "make_slab_frame_train_step", "make_train_step", "render_sharded", "shard_rays"]
