"""The port's training utilities (utils/speedometer.py, utils/tb.py,
utils/visualize.py) against the JAX package's on the CPU: the same log
message, TensorBoard scalars that read back, PNG grids with the same
pixels as the cv2-written ones (exact)."""
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from deepim_tpu.utils import speedometer as j_speedometer  # noqa: E402
from deepim_tpu.utils import visualize as j_vis  # noqa: E402
from deepim_tpu.utils.logger import logger as j_logger  # noqa: E402
from deepim_tpu_torch.utils import speedometer as t_speedometer  # noqa: E402
from deepim_tpu_torch.utils import visualize as t_vis  # noqa: E402
from deepim_tpu_torch.utils.logger import logger as t_logger  # noqa: E402
from deepim_tpu_torch.utils.png import read_png  # noqa: E402
from deepim_tpu_torch.utils.tb import TBLogger  # noqa: E402

torch.set_num_threads(2)


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _speedometer_messages(module, logger, monkeypatch):
    clock = iter(np.arange(100.0, 200.0, 0.5))
    monkeypatch.setattr(module.time, "time", lambda: float(next(clock)))
    records = _Messages()
    logger.addHandler(records)
    try:
        speedo = module.Speedometer(4, frequent=2)
        for epoch in (0, 1):
            for nbatch in range(5):
                speedo(epoch, nbatch, {"pm_loss/iter0": 0.25 + nbatch, "total": 1.0 / (nbatch + 1)}
                       if nbatch != 2 else None)
    finally:
        logger.removeHandler(records)
    return records.messages


def test_speedometer_message_equals_jax(monkeypatch):
    """The same batches and clock give the JAX Speedometer's messages,
    restarting its clock at each new epoch."""
    t_msgs = _speedometer_messages(t_speedometer, t_logger, monkeypatch)
    j_msgs = _speedometer_messages(j_speedometer, j_logger, monkeypatch)
    assert t_msgs == j_msgs and len(t_msgs) == 4
    assert t_msgs[1] == "Epoch[0] Batch [4]\tSpeed: 16.00 samples/sec\tpm_loss/iter0=4.250000\ttotal=0.200000"


def test_tb_logger_writes_scalars_and_weight_norms(tmp_path):
    """Enabled, TBLogger writes each scalar under train/<name> and the L2
    norm of every state_dict entry under weights/<name>; disabled, it
    writes nothing."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Conv2d(2, 4, 3))
    tb = TBLogger(str(tmp_path / "tb"))
    assert tb.enabled
    tb.scalars({"total": 0.5, "lr": 1e-4}, 7)
    tb.weight_norms(model, 2)
    tb.flush()
    tb.close()
    acc = EventAccumulator(str(tmp_path / "tb")).Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"train/total", "train/lr"} | {f"weights/{k}" for k in model.state_dict()}
    (event,) = acc.Scalars("train/total")
    assert (event.step, event.value) == (7, 0.5)
    for name, tensor in model.state_dict().items():
        (event,) = acc.Scalars(f"weights/{name}")
        assert event.step == 2
        assert event.value == pytest.approx(float(np.linalg.norm(tensor.numpy().ravel())), rel=1e-6)

    off = TBLogger(str(tmp_path / "off"), enabled=False)
    assert not off.enabled
    off.scalars({"total": 1.0}, 0)
    off.weight_norms(model, 0)
    off.flush()
    off.close()
    assert not (tmp_path / "off").exists()


def test_visualize_grids_equal_jax(tmp_path):
    """visualize_pair_grid and visualize_masks write PNGs that decode to
    the pixels of the JAX module's cv2-written files (RGB)."""
    rng = np.random.RandomState(0)
    obs = (rng.rand(3, 3, 12, 16) * 300 - 20).astype(np.float32)  # CHW, clipped to [0, 255]
    rend = (rng.rand(3, 3, 12, 16) * 255).astype(np.float32)
    masks = [(rng.rand(3, 1, 12, 16) > 0.5).astype(np.float32) for _ in range(3)]
    for name, args in (("pairs", (obs, rend)), ("masks2", masks[:2]), ("masks3", masks)):
        fn = "visualize_pair_grid" if name == "pairs" else "visualize_masks"
        getattr(j_vis, fn)(str(tmp_path / f"j_{name}.png"), *args, max_samples=2)
        getattr(t_vis, fn)(str(tmp_path / "sub" / f"t_{name}.png"), *args, max_samples=2)
        got, ref = read_png(str(tmp_path / "sub" / f"t_{name}.png")), read_png(str(tmp_path / f"j_{name}.png"))
        assert got.shape == ref.shape == (24, 16 * (3 if name != "masks2" else 2), 3)
        np.testing.assert_array_equal(got, ref, err_msg=name)
