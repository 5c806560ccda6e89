"""The 4-camera disentanglement model (``FourCamDisentangled``) on the port's
``fused`` route, on the CPU, where the kernels' plain versions run: its
views folded into the batch of the encoder-stage and decoder ops, its middle
one ``ftl_fusion`` op (ops/ftl_fusion.py), its peaks decoded per view-row.

Frames (2, 5 or 11, 48, 48, 16), filters 8, 72 maps; seeded weights with
running averages off their initial values; crop-adjusted cameras at unit
Frobenius norm. Tolerances: float32 routes agree to summation order (maps
within 1e-5 of their largest value, peaks equal); bf16 routes round their
convs, 1x1s and sums in different places, so their maps are held within 3%
of the largest value and each peak where the other route's map lies within
3% of its range below the maximum. The plain reference of the benchmark
(portbench/families/disentangled.py, float32) is held to 1e-4 of the maps'
range, the gap its float32 convolutions leave.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch import constants as C
from pose_estimation_amitai_torch import tracing, weights
from pose_estimation_amitai_torch.config import Config
from pose_estimation_amitai_torch.infer import Predictor, maps_by_channel, peaks_by_channel
from pose_estimation_amitai_torch.models import build_model
from pose_estimation_amitai_torch.models import fast_infer
from pose_estimation_amitai_torch.models.norm import EPSILON
from pose_estimation_amitai_torch.ops import custom_ops, geometry
from pose_estimation_amitai_torch.ops import ftl_fusion as ff
from pose_estimation_amitai_torch.ops import hopper_ftl
from pose_estimation_amitai_torch.train import loop

from test_torch_resnet import one_thread  # noqa: F401 (fixture)
from test_torch_tracing import _pe, _profiled

MT = C.ALL_CAMS_DISENTANGLED_PER_WING_CNN
SHAPE = (48, 48, 16)
K = 72
ROOT = Path(__file__).resolve().parent.parent
BF16_SHARE = 3e-2


@pytest.fixture(autouse=True)
def _one_thread_here(one_thread):
    """Every case of this file on one intra-op thread."""


def _cameras(n: int, seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """n samples' crop-adjusted (P, P_inv) of one four-camera rig."""
    gen = torch.Generator().manual_seed(seed)
    Ks = torch.tensor([[7500.0, 0, 640], [0, 7500.0, 400], [0, 0, 1]]).expand(4, 3, 3)
    Rs = torch.linalg.qr(torch.randn(4, 3, 3, generator=gen))[0]
    ts = torch.tensor([[0.0], [0.0], [210.0]]).expand(4, 3, 1)
    crops = torch.stack([torch.randint(0, 753, (n, 4), generator=gen),
                         torch.randint(0, 1233, (n, 4), generator=gen)], -1)
    return tuple(c.numpy() for c in geometry.crop_adjusted_matrices(Ks, Rs, ts, crops, 48))


@pytest.fixture(scope="module")
def variables():
    """flax params and batch_stats of a seeded model at filters 8 (biases and
    running averages moved off their initial values)."""
    cfg = Config(model_type=MT, num_base_filters=8, compute_dtype="float32")
    model = build_model(cfg, SHAPE, K)
    state = loop.create_train_state(model, cfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    params = weights.state_dict_to_flax(
        {n: v + 0.05 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
         for n, v in state.params.items()}, model)
    stats = weights.batch_stats_to_flax(
        {n: 0.5 + torch.rand(v.shape, generator=gen) if n.endswith("var") else
         torch.randn(v.shape, generator=gen) for n, v in state.batch_stats.items()})
    frames = np.random.default_rng(1).random((5, *SHAPE), dtype=np.float32)
    return params, stats, frames, _cameras(5)


def _predictor(variables, dtype="float32", fused=True, **kw) -> Predictor:
    params, stats, _, cams = variables
    cfg = Config(model_type=MT, num_base_filters=8, compute_dtype=dtype)
    kw = {"chunk_size": 2, "batch_stats": stats, "cameras": cams, **kw}
    return Predictor(cfg, params, SHAPE, K, device="cpu", use_fused=fused, **kw)


def _peak_gap(maps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """How far below each channel's maximum ``maps`` lies at ``pts``'s (x,
    y), over each sample's range."""
    n, h, w, k = maps.shape
    flat = maps.reshape(n, h * w, k)
    at = np.take_along_axis(flat, (pts[:, 1] * w + pts[:, 0]).astype(np.int64)[:, None], 1)
    rng = flat.max(axis=(1, 2)) - flat.min(axis=(1, 2))
    return (flat.max(axis=1) - at[:, 0]) / rng[:, None]


def test_fused_route_serves_the_flagship_geometry(variables):
    """use_fused serves the model at kernel 3, dilation 2, torch flavour and
    the per-pixel FTL layout on "fused"; other geometries, the source's raw
    layout and use_fused=False keep "module"."""
    params, stats, _, cams = variables
    assert _predictor(variables).serving_path == "fused"
    assert _predictor(variables, fused=False).serving_path == "module"
    cfg = Config(model_type=MT, num_base_filters=8, compute_dtype="float32", dilation_rate=1)
    other = build_model(cfg, SHAPE, K)
    pred = Predictor(cfg, weights.state_dict_to_flax(
        loop.create_train_state(other, cfg, seed=1, device="cpu").params, other), SHAPE, K,
        device="cpu", use_fused=True, batch_stats=stats, cameras=cams)
    assert pred.serving_path == "module"

    def raw_layout(**serving):
        from pose_estimation_amitai_torch.models import FourCamDisentangled

        return FourCamDisentangled(16, K, filters=8, dtype=torch.float32, ref_ftl_layout=True)

    pred = Predictor(Config(model_type=MT, num_base_filters=8, compute_dtype="float32"), params,
                     SHAPE, K, device="cpu", use_fused=True, batch_stats=stats, cameras=cams,
                     model=raw_layout)
    assert pred.serving_path == "module"


def test_fused_route_needs_the_running_averages(variables):
    params, _, _, cams = variables
    with pytest.raises(ValueError, match="running_mean"):
        Predictor(Config(model_type=MT, num_base_filters=8), params, SHAPE, K, device="cpu",
                  use_fused=True, cameras=cams)


def test_fused_matches_module_float32(variables):
    """5 samples in chunks of 2 (a padded tail): maps within 1e-5 of their
    largest value, peaks equal."""
    _, _, frames, _ = variables
    want_maps, want = _predictor(variables, fused=False, return_heatmaps=True)(frames)
    maps, pts = _predictor(variables, return_heatmaps=True)(frames)
    assert maps.shape == want_maps.shape == (5, 48, 48, K)
    assert np.abs(maps - want_maps).max() <= 1e-5 * np.abs(want_maps).max()
    np.testing.assert_array_equal(pts[:, :2], want[:, :2])
    np.testing.assert_allclose(pts[:, 2], want[:, 2], atol=1e-5 * np.abs(want_maps).max())


def test_fused_matches_module_bf16(variables):
    _, _, frames, _ = variables
    want_maps, want = _predictor(variables, "bfloat16", fused=False, return_heatmaps=True)(frames)
    maps, pts = _predictor(variables, "bfloat16", return_heatmaps=True)(frames)
    assert np.abs(maps - want_maps).max() <= BF16_SHARE * np.abs(want_maps).max()
    assert _peak_gap(want_maps, pts).max() <= BF16_SHARE
    assert _peak_gap(maps, want).max() <= BF16_SHARE


def test_fused_matches_the_benchmark_reference(variables):
    """The fused route in float32 against the benchmark's plain reference of
    the configuration (portbench/families/disentangled.py) on the same
    variables and cameras: maps within 1e-4 of their range, peaks where the
    reference's maps lie within 1e-4 of their range below the maximum."""
    from portbench.families import disentangled

    params, stats, frames, cams = variables
    spec = json.loads((ROOT / "portbench/configs/ftl_disentangled_cnn.json").read_text())
    spec.update(image_shape=list(SHAPE), filters=8)
    flat: dict = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[f"{prefix}{k}"] = torch.as_tensor(np.asarray(v, np.float32))

    walk("", params)
    walk(f"{disentangled.STATS}/", stats)
    assert set(flat) == {path for path, *_ in disentangled.leaves(spec)}
    ref = disentangled.forward(flat, torch.from_numpy(frames), spec,
                               P=torch.from_numpy(cams[0]),
                               P_inv=torch.from_numpy(cams[1])).numpy()
    maps, pts = _predictor(variables, return_heatmaps=True)(frames)
    rng = ref.max() - ref.min()
    assert np.abs(maps - ref).max() <= 1e-4 * rng
    assert _peak_gap(ref, pts).max() <= 1e-4


def _op_args(variables, dtype=torch.float32, n=2):
    """ftl_fusion's arguments for the view-rows of the first n samples'
    encoder outputs, and the module that made them."""
    params, stats, frames, cams = variables
    kp = fast_infer.disentangled_kernel_params(params, stats, dtype, "cpu")
    x = torch.from_numpy(frames[:n])
    rows = x.view(n, 48, 48, 4, 4).permute(0, 3, 1, 2, 4).reshape(4 * n, 48, 48, 4)
    lat = fast_infer._encode(kp, rows.to(dtype).contiguous(), 2)
    P, P_inv = (torch.from_numpy(c[:n]) for c in cams)
    return [lat, P, P_inv, *kp["ftl"], EPSILON]


def _per_op(variables, lat, P, P_inv) -> torch.Tensor:
    """The module's middle, op by op through its own layers and
    ops/geometry.py's FTLs, on NCHW views of the view-rows."""
    params, stats, _, _ = variables
    cfg = Config(model_type=MT, num_base_filters=8, compute_dtype="float32")
    model = build_model(cfg, SHAPE, K).eval()
    model.load_state_dict(weights.flax_to_state_dict(params, model, stats))
    n = lat.shape[0] // 4
    encs = [lat.view(n, 4, 48 // 4, 48 // 4, -1)[:, v].permute(0, 3, 1, 2) for v in range(4)]

    def ftl(fn, t, cam):
        return fn(t.permute(0, 2, 3, 1), cam).permute(0, 3, 1, 2)

    with torch.no_grad():
        canon = [ftl(geometry.ftl_inverse, model.rearrange1(e), P_inv[:, v])
                 for v, e in enumerate(encs)]
        f = torch.relu(model.bn1(model.fusion1(torch.cat(canon, dim=1))))
        f = torch.relu(model.bn2(model.fusion2(f)))
        outs = [model.rearrange2(torch.relu(model.bn3(ftl(geometry.ftl_project, f, P[:, v]))))
                + e for v, e in enumerate(encs)]
    return torch.stack([o.permute(0, 2, 3, 1) for o in outs], dim=1).reshape(lat.shape)


def test_ftl_fusion_plain_against_a_per_op_composition(variables):
    """The plain version and the card's composition (run here on CPU
    tensors) against the module's middle op by op, float32, within 1e-5 of
    the output's largest value; with the two samples' cameras swapped the
    output moves far beyond that."""
    args = _op_args(variables)
    want = _per_op(variables, *args[:3])
    scale = want.abs().max()
    for fn in (ff.ftl_fusion_plain, ff.ftl_fusion_gemm):
        got = fn(*args)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert (got - want).abs().max() <= 1e-5 * scale, fn.__name__
    swapped = list(args)
    swapped[1], swapped[2] = args[1].flip(0), args[2].flip(0)
    assert (ff.ftl_fusion_plain(*swapped) - want).abs().max() > 1e-2 * scale


def test_ftl_fusion_gemm_rounds_as_the_plain_version_bf16(variables):
    """In bf16 the two versions round at the same places: within one bf16
    step of the output's largest value."""
    args = _op_args(variables, torch.bfloat16)
    a, b = ff.ftl_fusion_plain(*args).float(), ff.ftl_fusion_gemm(*args).float()
    assert (a - b).abs().max() <= 2 ** -7 * a.abs().max()


def test_ftl_fusion_path_rule_and_checks(variables):
    """bf16 on the card at the kernel's widths (encoder 64, 128, 256 into a
    latent of 300) names "wgmma"; float32, and bf16 at other widths, "gemm";
    the CPU and other dtypes "plain", which launches nothing."""
    cuda, cpu, bf16, f32 = torch.device("cuda"), torch.device("cpu"), torch.bfloat16, torch.float32
    for width in (64, 128, 256):
        assert ff.ftl_path_for(cuda, bf16, width, 300) == "wgmma"
        assert ff.ftl_path_for(cuda, f32, width, 300) == "gemm"
        assert ff.ftl_path_for(cpu, bf16, width, 300) == "plain"
        assert ff.ftl_path_for(cpu, f32, width, 300) == "plain"
        assert ff.ftl_path_for(cuda, torch.float16, width, 300) == "plain"
    for width, latent in ((32, 300), (96, 300), (512, 300), (256, 150), (256, 303)):
        assert ff.ftl_path_for(cuda, bf16, width, latent) == "gemm"
    args = _op_args(variables)
    before = ff.ftl_fusion.launches, hopper_ftl.ftl_fusion_kernel.launches
    torch.testing.assert_close(custom_ops.ftl_fusion(*args), ff.ftl_fusion_plain(*args),
                               rtol=0, atol=0)
    # the plain version launches nothing
    assert (ff.ftl_fusion.launches, hopper_ftl.ftl_fusion_kernel.launches) == before
    bad = list(args)
    bad[2] = args[1]  # P where P_inv belongs
    with pytest.raises(ValueError, match="P_inv"):
        ff.ftl_fusion(*bad)
    with pytest.raises(ValueError, match="view-rows"):
        ff.ftl_fusion(args[0][:3], *args[1:])


def test_ftl_fusion_kernel_refuses_what_it_does_not_take(variables):
    """The kernel's wrapper raises before any launch: CPU tensors, float32,
    an encoder width it is not built for; its rule names exactly the
    bfloat16 widths it is built for, the instances pe_ftl_fusion
    dispatches to."""
    args = _op_args(variables, torch.bfloat16)
    before = hopper_ftl.ftl_fusion_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        hopper_ftl.ftl_fusion_kernel(*args)
    assert hopper_ftl.ftl_fusion_kernel.launches == before
    assert [hopper_ftl.ftl_kernel_takes(torch.bfloat16, c, 300) for c in (32, 64, 128, 256)] == \
        [False, True, True, True]
    assert not hopper_ftl.ftl_kernel_takes(torch.float32, 256, 300)
    assert not hopper_ftl.ftl_kernel_takes(torch.bfloat16, 256, 299)
    source = (Path(hopper_ftl.__file__).parents[1] / "csrc" / "ftl_fusion.cu").read_text()
    entry = source[source.index('extern "C" int pe_ftl_fusion('):]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", entry)) == hopper_ftl.WIDTHS


def test_ftl_fusion_opcheck(variables):
    torch.library.opcheck(custom_ops.ftl_fusion, tuple(_op_args(variables, n=1)))


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_predict_movie_keeps_camera_chunks_in_flight(variables, monkeypatch, prefetch):
    """A camera model's predict_movie dispatches ``prefetch`` chunks before
    it fetches the first, each with its own camera rows, and equals
    __call__ with a ragged tail (11 samples in chunks of 2)."""
    from pose_estimation_amitai_torch import infer

    frames = np.random.default_rng(2).random((11, *SHAPE), dtype=np.float32)
    pred = _predictor(variables, "bfloat16", cameras=_cameras(11, seed=4))
    want = pred(frames)
    order = []
    run, fetched = infer.Predictor._run, infer._fetched
    monkeypatch.setattr(infer.Predictor, "_run",
                        lambda self, *a: (order.append("run"), run(self, *a))[1])
    monkeypatch.setattr(infer, "_fetched", lambda p: (order.append("fetch"), fetched(p))[1])
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=prefetch), want)
    assert order[: prefetch + 1] == ["run"] * prefetch + ["fetch"]
    assert order.count("run") == 6  # five whole chunks and the tail


def test_module_route_movie_takes_camera_rows(variables):
    """The module route's predict_movie, pipelined too, equals its __call__;
    without cameras it raises."""
    params, stats, frames, _ = variables
    pred = _predictor(variables, fused=False)
    np.testing.assert_array_equal(pred.predict_movie(frames, prefetch=2), pred(frames))
    no_cams = Predictor(Config(model_type=MT, num_base_filters=8), params, SHAPE, K,
                        device="cpu", batch_stats=stats)
    with pytest.raises(ValueError, match="camera matrices"):
        no_cams.predict_movie(frames)


def test_view_rows_to_channels():
    """Peaks and maps of view-rows (row 4b + v) land in the module's channel
    order, view v in channels v K .. (v + 1) K."""
    pts = torch.arange(8 * 3 * 2).view(8, 3, 2)
    got = peaks_by_channel(pts, 4)
    assert got.shape == (2, 3, 8)
    for b in range(2):
        for v in range(4):
            assert torch.equal(got[b, :, 2 * v : 2 * v + 2], pts[4 * b + v])
    maps = torch.randn(8, 3, 5, 2)
    m = maps_by_channel(maps, 4)
    assert torch.equal(m[1, :, :, 6:8], maps[7]) and maps_by_channel(maps, 1) is maps


def test_spans_name_pe_ftl_inside_pe_forward(variables):
    """``pe.ftl`` is one of tracing.SPANS, and under a profiler each fused
    chunk holds one, inside its ``pe.forward``."""
    assert "pe.ftl" in tracing.SPANS
    _, _, frames, _ = variables
    pred = _predictor(variables)
    pred(frames[:2])
    _, events = _profiled(lambda: pred(frames))
    spans = _pe(events)
    assert spans.count(("pe.ftl", "pe.forward")) == spans.count(("pe.forward", "pe.call")) == 3
    assert [s for s in spans if s[0] == "pe.ftl"] == [("pe.ftl", "pe.forward")] * 3
