"""The port's examples (``examples/*_torch.py``, the jax-free versions of
``examples/quickstart.py``, ``train_moe.py`` and ``serve_moe.py``) run to
their end on the CPU at their smallest flags: the quickstart's FFN keeps
fp8_flow's 2 explicit casts, the train example's loop writes checkpoints
and its loss is finite, the serve example finishes every request."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import importlib.util
import math
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example():
    led = _example("quickstart_torch").main(["--device", "cpu"])
    assert led.activation_casts() == 2


def test_train_example_checkpoints(tmp_path):
    hist = _example("train_moe_torch").main(
        ["--device", "cpu", "--small", "--steps", "2", "--seq-len", "32",
         "--global-batch", "2", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "1"])
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
    assert any(tmp_path.iterdir())            # the step-1 checkpoint


def test_serve_example_finishes_every_request():
    results = _example("serve_moe_torch").main(
        ["--device", "cpu", "--requests", "2", "--max-new", "2"])
    assert len(results) == 2
    assert all(len(r["tokens"]) == 2 for r in results.values())
