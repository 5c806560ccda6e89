"""The port's Config and constants vs the JAX package's, field for field."""

import dataclasses
import os

import pytest

from pose_estimation_amitai_torch import constants as TC
from pose_estimation_amitai_torch.config import Config as TorchConfig
from pose_estimation_amitai_tpu import constants as JC
from pose_estimation_amitai_tpu.config import Config as JaxConfig

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.mark.parametrize("name", ["train_config.json", "selfsup_config.json"])
def test_config_json_parses_field_for_field(name):
    path = os.path.join(CONFIGS, name)
    got = TorchConfig.from_json(path)
    want = JaxConfig.from_json(path)
    assert got.to_dict() == want.to_dict()
    assert got.raw == want.raw


def test_config_defaults_and_fields_match():
    assert [f.name for f in dataclasses.fields(TorchConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig)
    ]
    assert TorchConfig().to_dict() == JaxConfig().to_dict()
    d = {"number of base filters": 16, "debug mode": 1, "zoom range": [0.9, 1.1],
         "// comment //": 0, "mesh_shape": [2, 4]}
    assert TorchConfig.from_dict(d).to_dict() == JaxConfig.from_dict(d).to_dict()


def test_constants_match():
    names = [n for n in dir(JC) if n.isupper()]
    for n in names:
        a, b = getattr(TC, n), getattr(JC, n)
        if hasattr(b, "tolist"):
            assert a.tolist() == b.tolist(), n
        else:
            assert a == b, n
    assert sorted(n for n in dir(TC) if n.isupper()) == sorted(names)
