"""Checkpoint and resume of fitting runs (PyTorch port of
sgrt_tpu.utils.checkpoint, which uses orbax).

A checkpoint is one file per step, <directory>/<step>/fit.pt, written with
torch.save: the scene's four tensors by field name (a GaussianScene's or an
AnisoScene's), the optimizer's state_dict and the step. The manager keeps the newest `max_to_keep` steps and deletes older
ones. Saves are synchronous.
"""

from __future__ import annotations

import os
import shutil

import torch

from sgrt_tpu_torch.parallel.fit import FitState, scene_fields

_FILE = "fit.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: FitState) -> None:
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        payload = {"scene": {f: getattr(state.scene, f).detach().cpu()
                             for f in scene_fields(state.scene)},
                   "opt_state": state.opt_state.state_dict(), "step": int(state.step)}
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: int, template: FitState) -> FitState:
        """Load step `step` into `template` (a FitState of the same shapes,
        its optimizer built over its scene): the scene tensors are
        overwritten in place, so the optimizer keeps them as parameters."""
        dev = template.scene.mu.device
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location=dev, weights_only=True)
        with torch.no_grad():
            for f in scene_fields(template.scene):
                getattr(template.scene, f).copy_(payload["scene"][f])
        template.opt_state.load_state_dict(payload["opt_state"])
        template.step = payload["step"]
        return template


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def save_fit(mgr: CheckpointManager, step: int, state: FitState) -> None:
    mgr.save(step, state)


def restore_fit(directory: str, template: FitState) -> FitState | None:
    """Restore the latest checkpoint into `template`; None if there is
    none."""
    mgr = make_manager(directory)
    step = mgr.latest_step()
    if step is None:
        return None
    return mgr.restore(step, template)
