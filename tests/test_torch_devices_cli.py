"""``python -m nvfi_torch.train_nvfi --devices N``: N ranks with the
data-parallel step, held to one process on the CPU.

Both runs train the CLI's tiny synthetic scene of
``tests/test_torch_trainer.py`` (``TINY_RUN``: an upsample after iteration 1,
an alpha-mask event after 2) from the same seed, so they start from the same
params and draw the same batches; the two ranks split each batch's ray
chunks.  The final params agree within the JAX package's own limits for a
sharded against an unsharded run (rtol 5e-3 / atol 2e-5,
``tests/test_train_e2e.py:101-102``).
"""

import json
import os

import numpy as np
import pytest
import torch

from nvfi_torch import train_nvfi
from nvfi_torch.config import load_config
from nvfi_torch.train import checkpoint

from test_torch_train import _flat
from test_torch_trainer import TINY_RUN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synth", "bat.yaml")
RUN = [*TINY_RUN, "nvfi.upsamp_list", "[1]", "nvfi.update_AlphaMask_list", "[2]",
       "renderer.batch_size", "256"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def untimed(events):
    return [{k: v for k, v in e.items() if k != "seconds"} for e in events]


def test_devices_2_trains_on_two_ranks_like_one_process(tmp_path):
    two = train_nvfi.main(["--config", CONFIG, "--static_dynamic", "--eval_test", "--devices",
                           "2", "--logdir", str(tmp_path / "two"), *RUN])
    one = train_nvfi.main(["--config", CONFIG, "--static_dynamic", "--devices", "1",
                           "--logdir", str(tmp_path / "one"), *RUN])
    tr = one["trainer"]
    rank0, rank1 = two["ranks"]
    assert rank0["global_step"] == rank1["global_step"] == tr.global_step == 3
    assert [(e["it"], e["kind"]) for e in rank0["events"]] == [(1, "upsample"), (2, "alpha")]
    assert untimed(rank0["events"]) == untimed(rank1["events"])
    assert rank0["meta"] == rank1["meta"]
    for path, w in _flat(checkpoint.params_to_numpy(tr.params)).items():
        if w is not None:
            np.testing.assert_allclose(_flat(rank0["params"])[path], w, rtol=5e-3, atol=2e-5,
                                       err_msg=path)
    # rank 0 alone wrote the logs: one line an iteration, the checkpoints, the eval
    names = set(os.listdir(tmp_path / "two"))
    assert {"config.yaml", "metrics.jsonl", "model_00002.npz", "time_sweep.gif",
            "test_img"} <= names
    logged = [json.loads(line) for line in open(tmp_path / "two" / "metrics.jsonl")]
    want = [json.loads(line) for line in open(tmp_path / "one" / "metrics.jsonl")]
    assert [m["it"] for m in logged] == [0, 1, 2]
    np.testing.assert_allclose([m["loss"] for m in logged], [m["loss"] for m in want],
                               rtol=2e-4)
    assert np.isfinite(two["eval"]["psnr"])
    assert load_config(str(tmp_path / "two" / "config.yaml")).experiment.train_iters == 3


def test_devices_0_is_every_visible_card(monkeypatch, tmp_path):
    """0 ranks asked: one process on the CPU, every card on the GPU; the static
    models train in one process whatever ``--devices`` says."""
    args = train_nvfi.parse_args(["--config", CONFIG, "--device", "cpu"])
    cfg = load_config(CONFIG)
    assert train_nvfi.n_ranks(args, cfg) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert train_nvfi.n_ranks(train_nvfi.parse_args(["--config", CONFIG]), cfg) == 4
    args = train_nvfi.parse_args(["--config", CONFIG, "--devices", "3"])
    assert train_nvfi.n_ranks(args, cfg) == 3
    cfg.nvfi.model_name = "TensorVMSplit"
    assert train_nvfi.n_ranks(args, cfg) == 1
