"""``EXPECTED_TRAIN_S2048`` of ``chip_smoke.py`` recomputed with the
reference on the CPU: smollm-135m at full width and depth on
``interop.seeded_params(seed=0)``, B 1 x 2048, where every layer's
attention takes the flash branch (the reference: ``flash_attention_ref``
under ``jax.grad``).  The helpers, and the rule, are
``tests/test_torch_backward_expected.py``'s; this cell has a file of its
own so that another worker takes it.  The port's float32 spread at these
2048 tokens (``TRAIN_SPREAD_S2048``) is measured by
``tools/train_spread.py``, not here: its two runs take ~8 minutes and
~12 GB.
"""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

HERE = Path(__file__).resolve().parent


def _expected_module():
    spec = importlib.util.spec_from_file_location(
        "test_torch_backward_expected", HERE / "test_torch_backward_expected.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_expected_train_s2048_is_the_reference():
    ex = _expected_module()
    cs = ex.chip_smoke()
    ex.reference_is("smollm-135m", {}, 1, cs.TRAIN_S2048_SEQ,
                    cs.EXPECTED_TRAIN_S2048)
