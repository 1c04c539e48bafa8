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

__all__ = ["FitState", "adam", "fit", "init_state", "make_aniso_frame_train_step",
           "make_frame_train_step",
           "make_frame_value_and_grad", "make_slab_frame_train_step", "make_train_step"]
