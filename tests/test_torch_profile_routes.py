"""The port's route profiler: its interval arithmetic, and its refusal to
run without a CUDA device (it traces the card only)."""

import pytest
import torch

from pose_estimation_amitai_torch import profile_routes


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlapping
    ([(5.0, 6.0), (0.0, 1.0), (5.2, 5.4)], 2.0),  # unsorted, nested
    ([(0.0, 1.0), (1.0, 2.5)], 2.5),  # touching
])
def test_union_of_device_intervals(spans, want):
    assert profile_routes._union_us(spans) == want


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        profile_routes.main([])
