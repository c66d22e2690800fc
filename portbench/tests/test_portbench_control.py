"""The control that every limit stands below: the reference put in the
program's place in float8 (the precision below the configuration's bf16),
and the planted faults, come out as not correct. On the CPU at a tiny size;
on the card (marked `cuda`) at each cell's own size."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import calibrate, harness

BENCH = harness.load_benchmark()


def _fails(readings: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in readings.items())


CASES = [(w["config"], w["traffic"], w["name"]) for w in BENCH["workloads"]]


def _tiny(config: str, traffic: str, limits: str):
    cfg = copy.deepcopy(harness.load_config(BENCH, config))
    image = 67 if cfg["architecture"] == "alexnet_dau" else 64
    cfg["image_size"] = image
    mix = {**harness.load_traffic(traffic), "batch": 4, "dataset_images": 16}
    return cfg, mix, harness.load_limits(limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _check(cfg, mix, limits, seed, dev):
    out = calibrate.train_control(cfg, mix, seed, dev)
    for side, (readings, _) in out.items():
        assert _fails(readings, limits), (side, readings, limits)


@pytest.mark.parametrize("config,traffic,limits", CASES, ids=[c[2] for c in CASES])
def test_control_and_faults_fail_at_a_tiny_size(config, traffic, limits):
    _check(*_tiny(config, traffic, limits), 2**33 + 41, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 51, 2**33 + 52, 2**33 + 53])
@pytest.mark.parametrize("config,traffic,limits", CASES, ids=[c[2] for c in CASES])
def test_control_and_faults_fail_at_the_cells_size(card, config, traffic, limits, seed):
    _check(harness.load_config(BENCH, config), harness.load_traffic(traffic),
           harness.load_limits(limits), seed, card)
