"""The CLI's ``train`` against its one-rank run: ``--fsdp 2`` and the model,
pipe and seq axes on two gloo ranks (as ``torchrun --nproc_per_node=2``
launches them), and ``--remat`` in one process. The rest of the training
entry points, and the one-rank run these compare with (``cli_run``: a seeded
``ofa_tiny`` through ``cli convert`` and 2 updates of ``cli train``), are in
``tests/test_torch_port_loop.py``; the CLI runs ``--device cpu --arch
ofa_tiny``.
"""

import shutil

import pytest
import torch

from musketeer_tpu_torch import cli
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.params import from_jax, init_ofa_params
from musketeer_tpu_torch.training import load_checkpoint
from musketeer_tpu_torch.training.train_state import named_leaves
from tests.test_torch_port_loop import IMG, cli_run, tsvs  # noqa: F401  (fixtures)
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("mode", ["fsdp2", "remat"])
def test_cli_train_fsdp_and_remat_match_one_rank(cli_run, tsvs, tmp_path, mode):
    """``cli train --fsdp 2`` on two gloo ranks (as ``torchrun --nproc_per_node=2``
    launches it), and ``--remat`` in one process, against ``cli_run``'s
    one-rank run of the same flags. The remat run's checkpoint equals it bit
    for bit. The fsdp run's is gathered from the two ranks' halves; the CLI
    trains the preset in bf16, where a row's products round differently in a
    batch of one row than of two, so Adam's moves are compared: no parameter
    moves 4·lr (2·lr for each of the two updates; lr = 1e-4) or more away from
    the one-rank run's move, and at most 0.1 % by half an lr or more
    (measured: 0.012 %, the largest 1.98·lr; a step that saw half of the
    batch, or misplaced a shard, flips far more)."""
    from musketeer_tpu_torch.parallel.dryrun import run_cli_ranks

    tasks = ",".join(f"{n}={tsvs[n]}" for n in ("caption", "snli_ve"))
    argv = ["train", "--tasks", tasks, "--arch", "ofa_tiny", "--device", "cpu",
            "--patch-image-size", str(IMG), "--max-update", "2", "--ema-decay", "0.9",
            "--save-dir", str(tmp_path / "run"), "--warmup-updates", "1"]
    if mode == "fsdp2":
        run_cli_ranks(2, argv + ["--fsdp", "2"])
    else:
        cli.main(argv + ["--remat"])
    got, meta = load_checkpoint(str(tmp_path / "run"), device="cpu")
    want = cli_run["state"]
    assert got.step == 2 and meta["num_updates"] == 2 and got.opt_state["count"] == 2
    leaves = lambda tree: [t.detach() for _, t in named_leaves(tree)]
    if mode == "remat":
        for name in ("params", "ema_params"):
            assert all(torch.equal(x, y) for x, y in zip(leaves(getattr(got, name)),
                                                         leaves(getattr(want, name)))), name
        return
    assert [t.shape for t in leaves(got.params)] == [t.shape for t in leaves(want.params)]
    before = leaves(from_jax(init_ofa_params(tc.ofa_tiny(), torch.Generator().manual_seed(7),
                                             "cpu"), tc.ofa_tiny(), "cpu", torch.float32))
    lr = 1e-4
    off = torch.cat([((x - p0) - (y - p0)).abs().flatten() for x, y, p0 in
                     zip(leaves(got.params), leaves(want.params), before)])
    assert float(off.max()) < 2 * 2 * lr
    assert float((off >= 0.5 * lr).float().mean()) <= 1e-3


AXES_FLAGS = {"model2": ["--model-parallel", "2"],
              "pipe2": ["--pipeline", "2", "--microbatches", "2"],
              "seq2": ["--seq-parallel", "2"]}


@pytest.mark.parametrize("axis", list(AXES_FLAGS))
def test_cli_train_axes_match_one_rank(cli_run, tsvs, tmp_path, axis):
    """``cli train --model-parallel 2`` (heads and FFN split), ``--pipeline 2
    --microbatches 2`` (GPipe, a row a microbatch) and ``--seq-parallel 2``
    (ring attention: the preset has no dropout, so the SP gate is open) on
    two gloo ranks, as ``torchrun --nproc_per_node=2`` launches them, against
    ``cli_run``'s one-rank run of the same flags: the checkpoint (the whole
    state, gathered) moved as the one-rank run's, within the bounds of the
    fsdp case (the preset trains in bf16, where split products round
    otherwise): the CLI logs no loss within two updates, and Adam's moves
    are its gradients' signs."""
    from musketeer_tpu_torch.parallel.dryrun import run_cli_ranks

    tasks = ",".join(f"{n}={tsvs[n]}" for n in ("caption", "snli_ve"))
    # cli_run's flags but its EMA, which moves no parameter (half the checkpoint)
    argv = ["train", "--tasks", tasks, "--arch", "ofa_tiny", "--device", "cpu",
            "--patch-image-size", str(IMG), "--max-update", "2",
            "--save-dir", str(tmp_path / "run"), "--warmup-updates", "1"]
    run_cli_ranks(2, argv + AXES_FLAGS[axis])
    got, meta = load_checkpoint(str(tmp_path / "run"), device="cpu")
    want = cli_run["state"]
    assert got.step == 2 and meta["num_updates"] == 2 and got.opt_state["count"] == 2
    leaves = lambda tree: [t.detach() for _, t in named_leaves(tree)]
    assert [t.shape for t in leaves(got.params)] == [t.shape for t in leaves(want.params)]
    before = leaves(from_jax(init_ofa_params(tc.ofa_tiny(), torch.Generator().manual_seed(7),
                                             "cpu"), tc.ofa_tiny(), "cpu", torch.float32))
    lr = 1e-4
    off = torch.cat([((x - p0) - (y - p0)).abs().flatten() for x, y, p0 in
                     zip(leaves(got.params), leaves(want.params), before)])
    assert float(off.max()) < 2 * 2 * lr
    assert float((off >= 0.5 * lr).float().mean()) <= 1e-3
    shutil.rmtree(tmp_path / "run")
