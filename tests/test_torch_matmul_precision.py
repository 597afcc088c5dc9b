"""``matmul_precision``, acted on by ``cli.run`` as the JAX ``cli`` acts on it
(``jax_default_matmul_precision``).

On the card ``high`` / ``tensorfloat32`` let cuBLAS and cuDNN use TF32,
``highest`` / ``float32`` / ``default`` keep fp32 products (on a TPU
``default`` means bf16 passes: the port keeps fp32, ROADMAP.md §C); any
other value raises, ``bfloat16`` among them.  A CPU run checks the value and
leaves the CPU's math alone.  The CUDA flags are process-global, so the
fixture puts back every one it lets a case touch.
"""

import pytest
import torch

from sheeprl_tpu_torch.config.compose import ConfigError
from sheeprl_tpu_torch.fabric import MATMUL_PRECISIONS, apply_matmul_precision

CARD = torch.device("cuda", 0)  # a device object only: no tensor is made on it


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def flags():
    saved = _flags()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize("value, tf32", [("default", False), ("highest", False), ("float32", False),
                                         ("high", True), ("tensorfloat32", True), (None, False)])
def test_each_value_sets_the_cuda_backends(flags, value, tf32):
    # start from the other setting, so each case shows a change
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not tf32
    torch.set_float32_matmul_precision("highest" if tf32 else "high")
    apply_matmul_precision(value, CARD)
    assert _flags() == (tf32, tf32, "high" if tf32 else "highest")


@pytest.mark.parametrize("value", sorted(MATMUL_PRECISIONS))
def test_a_cpu_run_leaves_the_cpu_math_alone(flags, value):
    before = _flags()
    apply_matmul_precision(value, torch.device("cpu"))
    assert _flags() == before


@pytest.mark.parametrize("device", [CARD, torch.device("cpu")], ids=["card", "cpu"])
@pytest.mark.parametrize("value", ["bfloat16", "medium", "HIGH"])
def test_an_unknown_value_raises(flags, value, device):
    before = _flags()
    with pytest.raises(ConfigError, match=r"not one the port takes \(default, highest, float32, high, "
                                          r"tensorfloat32\).*fabric.precision=bf16-mixed"):
        apply_matmul_precision(value, device)
    assert _flags() == before


def test_cli_run_reads_it(flags, tmp_path):
    """``cli.run`` checks the value before the loop starts (the refusal
    comes before any env or agent is built) and, on the CPU, trains with
    the CPU's math as it was."""
    from sheeprl_tpu_torch.cli import run
    from tests.test_torch_train_cli import ON_POLICY, ON_POLICY_COMMON

    recipe = [*ON_POLICY_COMMON, *ON_POLICY["ppo"], "env.sync_env=True", f"log_dir={tmp_path}"]
    with pytest.raises(ConfigError, match="matmul_precision 'bfloat16'"):
        run([*recipe, "matmul_precision=bfloat16"])
    assert not list(tmp_path.glob("**/checkpoint"))
    before = _flags()
    run([*recipe, "matmul_precision=high", "dry_run=True"])
    assert _flags() == before
    assert list(tmp_path.glob("**/checkpoint/step_*"))
