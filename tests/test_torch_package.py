"""Package rules of speinet_tpu_torch: no JAX, no speinet_tpu imports, the
card by default, kernel dispatch by the tensor's device alone."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import speinet_tpu_torch
from speinet_tpu_torch import kernels
from speinet_tpu_torch.config import Config, set_template
from speinet_tpu_torch.infer import Inference, main

PKG = pathlib.Path(speinet_tpu_torch.__file__).parent
# the package's sources; build/ holds only what the kernels' build writes
MODULES = sorted(p for p in PKG.rglob("*.py")
                 if p.relative_to(PKG).parts[0] != "build")


def test_fresh_import_leaves_jax_out():
    code = ("import sys\n"
            "import speinet_tpu_torch, speinet_tpu_torch.infer, "
            "speinet_tpu_torch.kernels, speinet_tpu_torch.utils.convert, "
            "speinet_tpu_torch.ops.metrics, speinet_tpu_torch.main_train, "
            "speinet_tpu_torch.main_swint, speinet_tpu_torch.models.swint, "
            "speinet_tpu_torch.detector.train, speinet_tpu_torch.ops.smoothing, "
            "speinet_tpu_torch.utils.image_utils, speinet_tpu_torch.pipeline, "
            "speinet_tpu_torch.parallel.mesh, speinet_tpu_torch.parallel.halo\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'speinet_tpu' or m.startswith('speinet_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PKG.parent, timeout=120)


def _import_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_speinet_tpu_import(path):
    bad = _import_roots(path) & {"jax", "jaxlib", "flax", "optax", "orbax",
                                 "speinet_tpu"}
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("script,allowed", [("chip_smoke.py", set()),
                                            ("orbax_to_torch.py", {"orbax"})])
def test_root_scripts_import_nothing_of_speinet_tpu(script, allowed):
    """The chip script imports nothing of JAX; the orbax converter only
    orbax (which brings JAX), never the JAX package."""
    bad = _import_roots(PKG.parent / script) & (
        {"jax", "jaxlib", "flax", "optax", "orbax", "speinet_tpu"} - allowed)
    assert not bad, f"{script} imports {bad}"


def _cfg():
    return set_template(Config(template="SPEINet")).replace(
        n_feat=8, embed_dim=32, depths=[2], num_heads=[4])


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inference(_cfg(), str(tmp_path), "", str(tmp_path / "r"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--data_path", str(tmp_path), "--cache_pyramids", "--n_feat", "8"])
    inf = Inference(_cfg(), str(tmp_path), "", str(tmp_path / "r"), device="cpu")
    inf.close()
    from speinet_tpu_torch.detector.train import main as detector_main
    from speinet_tpu_torch.main_swint import main as swint_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        swint_main(["--experiment_dir", str(tmp_path / "exp") + "/"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detector_main(["--dir-path", str(tmp_path), "--out-dir", str(tmp_path / "p")])
    assert not (tmp_path / "exp").exists() and not (tmp_path / "p").exists()


@pytest.mark.parametrize("argv,dtype", [
    ([], "bfloat16"), (["--device", "cpu"], "float32"),
    (["--compute_dtype", "float32"], "float32")])
def test_cli_computes_in_bf16_on_the_card(tmp_path, monkeypatch, argv, dtype):
    import speinet_tpu_torch.infer as infer_mod

    class Built(Exception):
        pass

    def record(cfg, *args, **kwargs):
        raise Built(cfg.compute_dtype)

    monkeypatch.setattr(infer_mod, "Inference", record)
    with pytest.raises(Built, match=f"^{dtype}$"):
        main(["--data_path", str(tmp_path), "--cache_pyramids", *argv])


@pytest.mark.parametrize("argv,data,result", [
    (["--default_data", "GOPRO"], "./data/deblur/GOPRO/test", "./infer_results/gopro"),
    (["--default_data", "BSD", "--data_path", "mine"], "mine", "./infer_results/bsd"),
    ([], "./dataset/test", "./infer_results")])
def test_cli_default_data_presets(monkeypatch, argv, data, result):
    """--default_data fills the paths the caller left at their defaults
    (speinet_tpu/infer.py:517-532)."""
    import speinet_tpu_torch.infer as infer_mod

    class Built(Exception):
        pass

    def record(cfg, data_path, model_path, result_path, **kwargs):
        raise Built(data_path, result_path)

    monkeypatch.setattr(infer_mod, "Inference", record)
    with pytest.raises(Built) as e:
        main(["--device", "cpu", *argv])
    assert e.value.args == (data, result)
    with pytest.raises(SystemExit, match="unknown preset"):
        main(["--device", "cpu", "--default_data", "NOPE"])


def test_card_takes_bf16_only(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="bfloat16"):
        Inference(_cfg(), str(tmp_path), "", str(tmp_path / "r"))


def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 10, 10, 32), generator=g)
    w = torch.rand((3, 3, 32, 16), generator=g)
    b = torch.rand((16,), generator=g)
    inv = torch.rand((1, 100), generator=g)
    idx = torch.randint(0, 100, (1, 37), generator=g)
    unf = lambda t: t.reshape(1, 100, 32).transpose(1, 2).contiguous()
    from speinet_tpu_torch.kernels.swin import SwinBlockWeights

    c, hid = 32, 64
    wts = SwinBlockWeights(*[torch.rand(s, generator=g) for s in (
        (c,), (c,), (2 * c, c), (2 * c,), (c, c), (c,), (c, c), (c,), (4, 25, 25),
        (c,), (c,), (hid, c), (hid,), (c, hid), (c,))])
    return [
        ("conv2d", lambda t: kernels.conv2d(t, w, b, relu=True),
         lambda t: kernels.conv2d_plain(t, w, b, relu=True)),
        ("roll2d", lambda t: kernels.roll2d(t, 2, 2), lambda t: kernels.roll2d_plain(t, 2, 2)),
        ("banded_corr_argmax", lambda t: kernels.banded_corr_argmax(t, t, inv)[0],
         lambda t: kernels.banded_corr_argmax_plain(t, t, inv)[0]),
        ("correlation_argmax_lds",
         lambda t: kernels.correlation_argmax_lds(unf(t), unf(t), inv)[0],
         lambda t: kernels.correlation_argmax_lds_plain(unf(t), unf(t), inv)[0]),
        ("swin_block", lambda t: kernels.swin_block(t, t, wts, 5, 0, 0, 0, 4),
         lambda t: kernels.swin_block_plain(t, t, wts, 5, 0, 0, 0, 4)),
        ("correlation_argmax_ld",
         lambda t: kernels.correlation_argmax_ld(unf(t), unf(t))[0],
         lambda t: kernels.correlation_argmax_ld_plain(unf(t), unf(t))[0]),
        ("correlation_argmax",
         lambda t: kernels.correlation_argmax(unf(t), t.reshape(1, 100, 32))[0],
         lambda t: kernels.correlation_argmax_plain(unf(t), t.reshape(1, 100, 32))[0]),
        ("window_cross_attention",
         lambda t: kernels.window_cross_attention(t, t, wts, 5, 0, 0, 0, 4),
         lambda t: kernels.window_cross_attention_plain(t, t, wts, 5, 0, 0, 0, 4)),
        ("ln_mlp", lambda t: kernels.ln_mlp(t, wts),
         lambda t: kernels.ln_mlp_plain(t, wts)),
        ("row_gather", lambda t: kernels.row_gather(t.reshape(1, 100, 32), idx),
         lambda t: kernels.row_gather_plain(t.reshape(1, 100, 32), idx)),
    ], x


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    calls, x = _wrapper_calls()
    assert sorted(name for name, _, _ in calls) == sorted(kernels.LAUNCHES)
    kernels.reset_launches()
    for name, fn, plain in calls:
        torch.testing.assert_close(fn(x), plain(x), rtol=0, atol=0, msg=name)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_other_devices_raise():
    calls, x = _wrapper_calls()
    xm = x.to("meta")
    for name, fn, _ in calls:
        inv_meta = torch.empty((1, 100), device="meta")
        if name == "banded_corr_argmax":
            fn = lambda t: kernels.banded_corr_argmax(t, t, inv_meta)
        elif name == "correlation_argmax_lds":
            fn = lambda t: kernels.correlation_argmax_lds(
                t.reshape(1, 100, 32).transpose(1, 2).contiguous(),
                t.reshape(1, 100, 32).transpose(1, 2).contiguous(), inv_meta)
        elif name == "row_gather":
            fn = lambda t: kernels.row_gather(t.reshape(1, 100, 32),
                                              torch.zeros((1, 4), dtype=torch.int64,
                                                          device="meta"))
        with pytest.raises(ValueError, match="device"):
            fn(xm)


def test_non_contiguous_input_is_refused():
    x = torch.rand((1, 10, 12, 32)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv2d(x, torch.rand((3, 3, 32, 16)), torch.rand(16))


def test_video_features_need_cuda_unless_cpu_is_asked(monkeypatch):
    import numpy as np
    from speinet_tpu_torch.detector.train import video_features

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.random.default_rng(0).integers(0, 256, (2, 24, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video_features(frames, kernel_size=11)
    feats = video_features(frames, kernel_size=11, device="cpu")
    assert feats.shape == (2, 6) and np.isfinite(feats).all()


CSRC_FILES = sorted(p.name for p in (PKG / "csrc").iterdir()
                    if p.suffix in (".cu", ".cuh"))


@pytest.mark.parametrize("name", CSRC_FILES)
def test_every_kernel_source_is_in_the_build_key(name):
    """A source or header left out of _lib.SOURCES / HEADERS would not be
    compiled, or an edit to it would reuse a stale library."""
    from speinet_tpu_torch.kernels import _lib

    assert name in _lib.SOURCES + _lib.HEADERS


@pytest.mark.parametrize("k,cin,co", [(5, 3, 32), (5, 128, 128), (3, 24, 32),
                                      (5, 48, 16), (3, 64, 192), (5, 256, 256),
                                      (5, 320, 64)])
def test_conv_slab_weights_order(k, cin, co):
    """The conv kernel streams its weights as contiguous slabs:
    [Co / N, slab, N / 8, slab row, 8] over the flattened (tap, padded input
    channel) axis, zero past Cin and past the last tap."""
    from speinet_tpu_torch.kernels.conv import slab_weights

    w = torch.randn((k, k, cin, co), generator=torch.Generator().manual_seed(k * cin))
    ws = slab_weights(w)
    n = next(t for t in (128, 64, 32, 16) if co % t == 0)
    rows = 64 if n >= 64 else 128
    cinp = 16 if cin <= 16 else 32 if cin <= 32 else -(-cin // 64) * 64
    assert ws.shape == (co // n, -(-(k * k * cinp) // rows), n // 8, rows, 8)
    flat = ws.permute(1, 3, 0, 2, 4).reshape(-1, co)    # [slab * row, Co]
    kidx = torch.arange(flat.shape[0])
    tap, c = kidx // cinp, kidx % cinp
    live = (tap < k * k) & (c < cin)
    want = torch.zeros_like(flat)
    want[live] = w.reshape(k * k, cin, co)[tap[live], c[live]]
    assert torch.equal(flat, want)


@pytest.mark.parametrize("k,cin,co", [(5, 256, 256), (5, 128, 256), (5, 320, 64),
                                      (3, 200, 128)])
def test_conv_grouped_slab_index(k, cin, co):
    """Where K1 stages the input channels 64 at a time (rows too wide for
    shared memory), it walks (group g, tap) in that order and reads slab
    tap * groups + g of the wrapper's tap-major layout: that slab holds
    channels 64 g .. 64 g + 63 of the tap."""
    from speinet_tpu_torch.kernels.conv import slab_weights

    w = torch.randn((k, k, cin, co), generator=torch.Generator().manual_seed(cin))
    ws = slab_weights(w)                      # [Co / N, slab, N / 8, 64, 8]
    n = next(t for t in (128, 64, 32, 16) if co % t == 0)
    cinp = -(-cin // 64) * 64
    groups = cinp // 64
    wp = torch.zeros((k * k, cinp, co))
    wp[:, :cin] = w.reshape(k * k, cin, co)
    for g in range(groups):
        for tap in range(k * k):
            slab = ws[:, tap * groups + g]    # [Co / N, N / 8, 64, 8]
            got = slab.permute(2, 0, 1, 3).reshape(64, co)
            assert torch.equal(got, wp[tap, 64 * g:64 * g + 64]), (g, tap)
    assert ws.shape[1] == k * k * groups and n >= 64


def test_unfold_kernels_batch_limit():
    """K5-K7 launch one grid row per sample: the wrappers refuse more than
    MAX_BATCH samples before any launch."""
    from speinet_tpu_torch.kernels.corr import MAX_BATCH, _check_batch

    _check_batch("correlation_argmax", MAX_BATCH)
    with pytest.raises(ValueError, match="at most 65535"):
        _check_batch("correlation_argmax", MAX_BATCH + 1)
