"""The port's on-device verification entry point (sgrt_tpu_torch.verify)
against the JAX package's verify_tpu.py: the same checks by name, and the
quick run passing on the CPU, where the kernel route runs the kernels'
plain versions.

verify_tpu.py runs on the accelerator; on the CPU its full-size checks take
minutes in either package, so the quick run here sets the module's sizes to
an 8x8 ray grid for checks 1 and 3 and 64x64 frames for check 2 (the
scenes, tolerances and check 5 as they are). chip_smoke.py runs the full
checks on the card.
"""

import ast
from pathlib import Path

from sgrt_tpu_torch import verify

ROOT = Path(__file__).resolve().parents[1]
# verify_tpu.py's quick run records these (run_checks, quick=True)
QUICK_NAMES = ["fwd_untiled_vs_xla", "fwd_tiled_cube", "grad_untiled_mu", "grad_untiled_sigma",
               "grad_untiled_magnitude", "grad_untiled_albedo", "counts_fwd", "counts_bwd_dmu",
               "counts_bwd_dcoeff"]


def _recorded_names(path):
    """The first argument of every record(...) call, f-string fields as {},
    sorted."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "record":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                names.append("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                     for v in arg.values))
            else:
                names.append(arg.value)
    return sorted(names)


def test_same_checks_as_verify_tpu():
    want = _recorded_names(ROOT / "verify_tpu.py")
    assert _recorded_names(ROOT / "sgrt_tpu_torch" / "verify.py") == want
    assert len(want) == 8 and "grad_tiled_teapot_{}" in want


def test_quick_run_on_cpu_passes(monkeypatch):
    monkeypatch.setattr(verify, "RAYS", 8)
    monkeypatch.setattr(verify, "FRAME", 64)
    report = verify.run_checks(quick=True, device="cpu")
    assert report["parity_ok"] is True
    assert report["device"] == "cpu" and report["compiled"] is False
    assert list(report["checks"]) == QUICK_NAMES
    assert all(c["ok"] and c["max_rel_err"] <= c["tol"] for c in report["checks"].values())
