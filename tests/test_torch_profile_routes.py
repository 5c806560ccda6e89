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


@pytest.mark.parametrize("route", list(profile_routes.ROUTES))
def test_route_options_give_the_route(route):
    """Each named route's Predictor options serve that route (tiny net, CPU)."""
    import numpy as np

    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.config import Config
    from pose_estimation_amitai_torch.infer import Predictor

    rng = np.random.default_rng(0)
    opts = dict(profile_routes.ROUTES[route])
    if opts.get("use_quantized"):
        opts["calibration_frames"] = rng.random((2, 16, 16, 4), dtype=np.float32)
    pred = Predictor(Config(num_base_filters=8),
                     weights.init_basicnet_params(rng, 4, 3, filters=8),
                     (16, 16, 4), 3, device="cpu", **opts)
    assert pred.serving_path == route


def test_unknown_route_is_refused():
    with pytest.raises(SystemExit):
        profile_routes.main(["--routes", "int8_generic"])


def test_vit_route_on_basicnet_is_refused():
    with pytest.raises(SystemExit):
        profile_routes.main(["--model", "vit", "--routes", "int8_fused"])


@pytest.mark.parametrize("model", ["basicnet", "vit"])
def test_model_setup_gives_full_width(model):
    """--model's config and seeded params: the default widths, and a tree
    the model's state_dict takes (on the meta device: no weights made)."""
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.models import build_model

    cfg, params, routes = profile_routes.model_setup(model)
    with torch.device("meta"):
        net = build_model(cfg, profile_routes.SHAPE, profile_routes.K)
    if model == "vit":
        assert set(routes) == {"fused", "module"}
        attn = net.transformer.attn0
        assert (attn.dim, attn.heads, attn.dim_head) == (256, 8, 256)
        assert net.transformer.depth == 8 and net.patch_embed.pos_embedding.shape == (
            1, 144, 256)
        sd = weights.vit_state_dict(params)
    else:
        assert set(routes) == set(profile_routes.ROUTES)
        sd = weights.basicnet_state_dict(params)
    want = net.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)


def test_train_profile_takes_no_routes_and_needs_cuda():
    with pytest.raises(SystemExit):
        profile_routes.main(["--model", "train", "--routes", "fused"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            profile_routes.main(["--model", "train"])
