"""The port's data parallelism (speinet_tpu_torch.parallel) on the CPU.

Spawned processes form a gloo group through a file rendezvous (a fixed port
would collide between test workers) and serve the tests' tasks: a `Group`
starts once per test module and each task runs on every rank at once, with
a timeout, so a collective that hangs fails its test instead of stalling
the suite. Every process runs torch on one thread.

- the data-parallel train step (1*L1+2*HEM, DropPath 0.1) on two ranks
  against the single-process step on the concatenated batch, and the same
  check rejecting gates whose statistics stay local;
- `sharded_conv2d` on four ranks against the JAX package's unsharded
  depthwise convolution (tests/test_halo.py's oracle);
- `main_train` for one epoch on two ranks against one process, rank 0
  alone writing, and the `--dp_devices` rule;
- `infer.py`'s engines (direct, cached, chopped) on two ranks against one
  process.

This module imports no JAX at its top: the spawned processes import it to
find their tasks. The JAX package is imported inside the tests that need it.
"""

import builtins
import glob
import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

TASK_TIMEOUT = 240      # seconds for one task on every rank
TINY = dict(n_feat=8, embed_dim=32, depths=(2,), num_heads=(4,),
            window_size=5, mlp_ratio=2.0)
TINY_CFG = dict(n_feat=8, embed_dim=32, depths=[2], num_heads=[4], n_threads=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in every process of a group."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the process group --------------------------------------------------

def _serve(rank, world, init, tasks, results):
    """A rank: join the group, then run (fn, args) tasks until None."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TASK_TIMEOUT))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except BaseException:      # reported to the test, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Group:
    """`world` spawned processes in one gloo group."""

    def __init__(self, world: int, rdzv_dir):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        init = f"file://{rdzv_dir}/rdzv"
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, init, self.tasks[r], self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = TASK_TIMEOUT):
        """fn(*args) on every rank; the results in rank order. A failure or
        a timeout on any rank closes the group and raises."""
        for q in self.tasks:
            q.put((fn, args))
        out = {}
        deadline = time.time() + timeout
        while len(out) < self.world:
            try:
                r, ok, val = self.results.get(timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(out)} of "
                                   f"{self.world} answered in {timeout} s") from None
            if not ok:
                self.close()
                raise RuntimeError(f"{fn.__name__} failed on rank {r}:\n{val}")
            out[r] = val
        return [out[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    g = Group(2, tmp_path_factory.mktemp("rdzv"))
    yield g
    g.close()


# --- tasks (run on every rank) ----------------------------------------------

def _state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def min_pool_gap(model, run) -> float:
    """Smallest top-2 gap, over every line that a TripletAttention gate
    max-pools while `run()` runs, relative to that map's max |value|."""
    from speinet_tpu_torch.models.blocks import TripletAttention

    gaps = []

    def hook(_, args):
        x = args[0].detach().float()
        for dim in (1, 2):                       # over H, over W (NHWC)
            top = x.topk(2, dim=dim).values
            gap = top.select(dim, 0) - top.select(dim, 1)
            gaps.append((gap.min() / x.abs().max()).item())

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, TripletAttention)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    assert gaps
    return min(gaps)


def step_on_rows(model_kw, state, x, gt, loss, lr, seed, local_stats=False):
    """One train step of a model built from `model_kw` and `state` on this
    rank's rows of the global batch (x, gt). With `local_stats` the gates'
    statistics are computed without the all-reduce (the planted fault).
    Returns the loss, the gradients, the state after the step and the
    smallest max-pool gap of the rank's rows."""
    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.models import blocks
    from speinet_tpu_torch.models.speinet import SPEINet
    from speinet_tpu_torch.parallel.mesh import batch_slice
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import make_optimizer, train_step

    model = SPEINet(**model_kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    cfg = set_template(Config(template="SPEINet")).replace(loss=loss, lr=lr)
    rows = batch_slice(len(x))
    out = {}

    def step():
        out["total"], out["comps"] = train_step(
            model, make_optimizer(cfg, model), LossComputer(cfg.loss),
            torch.from_numpy(x[rows]), torch.from_numpy(gt[rows]),
            torch.Generator().manual_seed(seed))

    reduce = blocks.all_reduce_sum
    if local_stats:
        blocks.all_reduce_sum = lambda t: t
    try:
        gap = min_pool_gap(model, step)
    finally:
        blocks.all_reduce_sum = reduce
    return dict(total=out["total"].item(),
                comps={k: v.item() for k, v in out["comps"].items()},
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
                       if p.grad is not None},
                state=_state(model), gap=gap)


def _record_writes(under: str, fn, *args):
    """fn(*args) with every file opened for writing and every directory
    made under `under` recorded: (result, paths)."""
    paths = []
    real_open, real_makedirs = builtins.open, os.makedirs

    def rec_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and str(file).startswith(under):
            paths.append(str(file))
        return real_open(file, mode, *a, **k)

    def rec_makedirs(name, *a, **k):
        if str(name).startswith(under):
            paths.append(str(name))
        return real_makedirs(name, *a, **k)

    builtins.open, os.makedirs = rec_open, rec_makedirs
    try:
        return fn(*args), paths
    finally:
        builtins.open, os.makedirs = real_open, real_makedirs


def main_train_on_rank(argv, under):
    """main_train's CLI on this rank: the paths it wrote under `under`."""
    from speinet_tpu_torch.main_train import main

    return _record_writes(under, main, argv)[1]


def main_train_error(argv):
    """The error main_train raises on this rank, by type and message."""
    from speinet_tpu_torch.main_train import main

    try:
        main(argv)
    except ValueError as e:
        return f"ValueError: {e}"
    return None


def infer_frames(cfg_kw, data_path, result_path, model_path, kw):
    """The port's Inference on a PNG tree: (restored frames by name, the
    per-video PSNR lists, the window batch, the paths written under
    `result_path`)."""
    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.infer import Inference

    cfg = set_template(Config(template="SPEINet")).replace(**cfg_kw)
    frames = {}

    def run():
        inf = Inference(cfg, data_path, model_path, result_path, device="cpu", **kw)
        score = inf._score_chunk

        def keep(v, names, out, *args):
            for k, name in enumerate(names):
                frames[f"{v}/{name}"] = out[k].numpy().copy()
            return score(v, names, out, *args)

        inf._score_chunk = keep
        try:
            inf.infer()
        finally:
            inf.close()
        return dict(inf.total_psnr), inf.batch_windows

    (psnr, bw), paths = _record_writes(result_path, run)
    return frames, psnr, bw, paths


def halo_rows(x, kernel):
    """This rank's rows of sharded_conv2d over the H axis of x."""
    from speinet_tpu_torch.parallel.halo import sharded_conv2d
    from speinet_tpu_torch.parallel.mesh import rank, world

    h = x.shape[1] // world()
    local = torch.from_numpy(x[:, rank() * h:(rank() + 1) * h])
    return sharded_conv2d(torch.from_numpy(kernel))(local).numpy()


# --- the train step -----------------------------------------------------------

# Per-tensor tolerance of a data-parallel step against one process: the two
# sum the batch in different orders (per rank, then over the group), and in
# float32 that alone moves a gradient whose terms cancel by up to 2.4e-5 of
# its max |.| on this batch (recons_net.outBlock.3.bias); the planted local
# statistics move the loss itself beyond 1e-5 and the gradients by far more.
STEP_TOL = 1e-4


def _rel_errors(got: dict, want: dict) -> dict:
    """Per tensor max|got - want| / max|want| (0 / 0 taken as 0)."""
    assert want and set(got) == set(want)
    out = {}
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max(initial=0))
        scale = float(np.abs(w).max(initial=0))
        out[name] = err / scale if scale else (0.0 if err == 0 else np.inf)
    return out


def _dp_batch():
    """Four [5, 3, 40, 40] windows, samples 1 and 2 routed to the self
    reference, and their centre ground truth."""
    from test_torch_models import _frames

    x = np.stack([_frames(5, 40, 40, seed=70 + k) for k in range(4)])
    x[1, 3] = 0.0
    x[2, 3] = 0.0
    gt = np.clip(x[:, 1] * 1.05 - 0.02, 0.0, 1.0).astype(np.float32)
    return x, gt


@pytest.mark.parametrize("local_stats", [False, True],
                         ids=["global_stats", "planted_local_stats"])
def test_dp_step_matches_single_process(group2, local_stats):
    """Two ranks of two samples each, loss 1*L1+2*HEM, DropPath 0.1: the
    loss (within 1e-5), every gradient, the weights after Adam and the
    running statistics (per tensor within STEP_TOL of its max |.|) against
    the port's single-process step on the concatenated batch; the running
    statistics equal on both ranks. With the gates' statistics left local
    the comparison must fail."""
    from speinet_tpu_torch.config import Config, set_template
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights
    from speinet_tpu_torch.training.loss import LossComputer
    from speinet_tpu_torch.training.train_state import make_optimizer, train_step

    kw = dict(TINY, drop_path_rate=0.1)
    loss, lr, seed = "1*L1+2*HEM", 1e-4, 5
    model = init_weights(SPEINet(**kw), seed=3)
    state = _state(model)
    x, gt = _dp_batch()
    cfg = set_template(Config(template="SPEINet")).replace(loss=loss, lr=lr)
    total, comps = train_step(model, make_optimizer(cfg, model), LossComputer(loss),
                              torch.from_numpy(x), torch.from_numpy(gt),
                              torch.Generator().manual_seed(seed))
    want_grads = {n: p.grad.numpy() for n, p in model.named_parameters()
                  if p.grad is not None}
    want_state = _state(model)
    ranks = group2.run(step_on_rows, kw, state, x, gt, loss, lr, seed, local_stats)

    def check():
        """Every rank holds the averaged gradient and takes the same step."""
        worst = max(((f"rank {i} {what} {n}", e) for i, r in enumerate(ranks)
                     for what, want in (("grads", want_grads), ("state", want_state))
                     for n, e in _rel_errors(r[what], want).items()),
                    key=lambda kv: kv[1])
        print(f"largest per-tensor |dp - single| / max|single|: {worst}")
        for r in ranks:
            assert max(_rel_errors(r["grads"], want_grads).values()) <= STEP_TOL
            assert max(_rel_errors(r["state"], want_state).values()) <= STEP_TOL
        np.testing.assert_allclose(np.mean([q["total"] for q in ranks]),
                                   total.item(), rtol=1e-5)
        for k, v in comps.items():
            np.testing.assert_allclose(np.mean([q["comps"][k] for q in ranks]),
                                       v.item(), rtol=1e-5)
        stats = [k for k in want_state if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            assert np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k]), k

    if local_stats:
        with pytest.raises(AssertionError):
            check()
    else:
        check()


# --- halo exchange ------------------------------------------------------------

def test_sharded_conv2d_matches_jax(tmp_path):
    """sharded_conv2d on four ranks (H = 64, 16 rows each) against the JAX
    package's unsharded depthwise SAME conv, as tests/test_halo.py holds
    the JAX version."""
    import jax.numpy as jnp
    from speinet_tpu.ops.filters import box_kernel, depthwise_conv2d

    x = np.random.default_rng(0).random((2, 64, 40, 8)).astype(np.float32)
    k = np.asarray(box_kernel(5))
    want = np.asarray(depthwise_conv2d(jnp.asarray(x.transpose(0, 3, 1, 2)),
                                       jnp.asarray(k))).transpose(0, 2, 3, 1)
    group = Group(4, tmp_path)
    try:
        got = np.concatenate(group.run(halo_rows, x, k), axis=1)
    finally:
        group.close()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_halo_exchange_without_a_group_pads_zeros():
    """One process holds every row: both halos are the zero border."""
    from speinet_tpu_torch.ops.filters import depthwise_conv2d
    from speinet_tpu_torch.parallel.halo import halo_exchange, sharded_conv2d

    x = torch.rand(1, 6, 5, 2)
    y = halo_exchange(x, 2)
    assert y.shape == (1, 10, 5, 2)
    assert not y[:, :2].any() and not y[:, -2:].any() and torch.equal(y[:, 2:-2], x)
    k = torch.rand(3, 3)
    want = depthwise_conv2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    torch.testing.assert_close(sharded_conv2d(k)(x), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="halo"):
        halo_exchange(x, 7)


# --- training -----------------------------------------------------------------

def _train_argv(root, exp, *extra):
    from test_end_to_end import TINY_ARGS

    return (["--device", "cpu", "--template", "SPEINet", "--dir_data", str(root),
             "--dir_data_test", str(root), "--experiment_dir", str(exp) + "/",
             "--save", "run", "--epochs", "1", "--seed", "4"] + TINY_ARGS
            + list(extra))


def test_main_train_two_ranks_matches_one_process(group2, tmp_path):
    """One epoch of batch 2 on two ranks (one sample each) against one
    process: rank 0 alone writes; the checkpoint's weights and running
    statistics, the loss log and the PSNR log agree; the log says the
    group's size."""
    from speinet_tpu_torch.main_train import main
    from test_end_to_end import make_tree

    root = make_tree(tmp_path / "ds", n_frames=6)
    main(_train_argv(root, tmp_path / "one"))
    writes = group2.run(main_train_on_rank, _train_argv(root, tmp_path / "dp"),
                        str(tmp_path))
    run = str(tmp_path / "dp" / "run")
    assert any(p.startswith(run) for p in writes[0]), writes[0]
    assert writes[1] == [], writes[1]

    one, dp = tmp_path / "one" / "run", tmp_path / "dp" / "run"
    ck1 = torch.load(one / "model" / "model_latest", weights_only=True)
    ck2 = torch.load(dp / "model" / "model_latest", weights_only=True)
    assert ck1["step"] == ck2["step"] > 1 and ck1["epoch"] == ck2["epoch"] == 1
    errors = _rel_errors({k: v.numpy() for k, v in ck2["model"].items()},
                         {k: v.numpy() for k, v in ck1["model"].items()})
    assert max(errors.values()) <= STEP_TOL, max(errors.items(), key=lambda kv: kv[1])
    for f in ("psnr.npy", "loss.npy", "loss_components.npy"):
        np.testing.assert_allclose(np.load(dp / f), np.load(one / f), rtol=1e-5,
                                   err_msg=f)
    log = (dp / "log.txt").read_text()
    assert "dp group: 2 device(s)" in log and log.count("Epoch   1 with") == 1
    assert "dp group: 1 device(s)" in (one / "log.txt").read_text()


def test_dp_devices_must_be_the_group_size(group2, tmp_path):
    """--dp_devices other than 0 or the group's size raises on every rank
    before anything is written; without a group it must be 0 or 1."""
    from speinet_tpu_torch.main_train import main
    from test_end_to_end import make_tree

    root = make_tree(tmp_path / "ds", n_frames=6)
    errors = group2.run(main_train_error,
                        _train_argv(root, tmp_path / "dp", "--dp_devices", "3"))
    assert all(e and "--dp_devices 3" in e and "2 process(es)" in e for e in errors)
    assert not (tmp_path / "dp").exists()
    with pytest.raises(ValueError, match="1 process"):
        main(_train_argv(root, tmp_path / "one", "--dp_devices", "2"))


# --- inference ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["direct", "cached", "chop"])
def test_infer_two_ranks_matches_one_process(group2, tmp_path, engine):
    """The engine on two ranks against one process on the same tree and
    weights: every restored frame within 1e-5, the PSNRs within 1e-3 dB;
    rank 0 alone
    writes; the direct and cached window batches round up to the group."""
    from speinet_tpu_torch.models.speinet import SPEINet, init_weights
    from test_end_to_end import make_tree

    root = str(make_tree(tmp_path / "ds", n_frames=7))
    pt = str(tmp_path / "w.pt")
    torch.save(init_weights(SPEINet(**TINY), seed=2).state_dict(), pt)
    cfg_kw = dict(TINY_CFG, chop=engine == "chop")
    kw = dict(batch_windows=3 if engine == "cached" else 1,
              cache_pyramids=engine == "cached")
    want, want_psnr, want_bw, _ = infer_frames(cfg_kw, root, str(tmp_path / "one"),
                                               pt, kw)
    ranks = group2.run(infer_frames, cfg_kw, root, str(tmp_path / "dp"), pt, kw)
    assert len(want) == 7 and want_bw == kw["batch_windows"]
    for frames, psnr, bw, _ in ranks:
        assert bw == (1 if engine == "chop" else 2 * -(-kw["batch_windows"] // 2))
        assert set(frames) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(frames[name], w, rtol=0, atol=1e-5, err_msg=name)
        # PSNR of the uint8 frames: a pixel that rounds the other way moves
        # it by ~2e-5 dB here
        np.testing.assert_allclose(psnr["video00"], want_psnr["video00"], atol=1e-3)
    assert ranks[0][3] and ranks[1][3] == []
    assert len(glob.glob(str(tmp_path / "dp" / "video00" / "*.png"))) == 7
    assert len(glob.glob(str(tmp_path / "dp" / "inference_log_*.txt"))) == 1
