"""The port's multi-process layer (parallel/distributed.py) on the CPU, against
the JAX package's (tests/test_distributed.py).

- Two processes over gloo, each holding 4 of the mesh's 8 data rows
  (``[cpu] * 4``), run FGSM and its success counters on their rows of one
  global batch; the counters summed over the processes equal the
  one-process counters and JAX's.
- Two processes run one PGD-AT step of ``wrn_tiny`` (float64) on their
  halves of a batch, the gradients summed over the processes: the
  parameters equal the one-process step's within 1e-6; also with
  ``train_bn`` (the batch statistics summed over the processes) and
  ``grad_accum=2`` (the batch gathered, each micro-batch split over all
  eight data rows).
- The grid CLI in two processes (each joined at import, one data row each)
  prints the one-process summary lines, resident and streamed.
- The draws that need the whole batch across the two processes: EOT-PGD
  (each call's input mix summed over both processes' shards) and shot
  noise (the Poisson counts of both processes' rates) equal the
  one-process run bit for bit, and a SmoothAdv step with ``train_bn`` and
  remat (the recompute reading the statistics summed over the processes)
  equals the one-process step within 1e-6.
- One process: ``make_dcn_mesh`` is ``make_mesh`` and ``process_local_batch``
  places the whole batch (JAX's single-process cases); the env contract is a
  no-op when unset; NCCL asked for without a card raises.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_recognition_adversarial_example_attack_tpu.attacks import fgsm_attack
from image_recognition_adversarial_example_attack_tpu.attacks import make_logits_fn as jax_lf
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.models.tiny import make_tiny
from _torch_scaleout_helpers import train_setup
from image_recognition_adversarial_example_attack_tpu_torch.parallel import distributed
from image_recognition_adversarial_example_attack_tpu_torch.parallel.distributed import (
    make_dcn_mesh, maybe_initialize_distributed, process_local_batch)

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240

# One pair of worker processes runs every two-process case (a process takes
# seconds to import torch and the port): the grid CLI joins the process
# group at import (cli/common.py), then FGSM's counters, the grid CLI
# resident and streamed, and the PGD-AT steps run one after another.
_WORKER = r"""
import contextlib, io, json, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from image_recognition_adversarial_example_attack_tpu_torch.cli import defense_experiments
import torch.distributed as dist
assert dist.is_initialized()  # the CLI joined at import (cli/common.py)
from image_recognition_adversarial_example_attack_tpu_torch.parallel.distributed import (
    all_reduce_sum, make_dcn_mesh, maybe_initialize_distributed, process_count,
    process_local_batch)
assert maybe_initialize_distributed()  # idempotent
out_dir, jobs = Path(sys.argv[1]), json.loads(sys.argv[2])
rank = dist.get_rank()
cpu = torch.device("cpu")
mesh = make_dcn_mesh(n_model=1, devices=[cpu] * 4)

# FGSM's counters on this process's 4 of the mesh's 8 data rows
from image_recognition_adversarial_example_attack_tpu_torch.attacks import fgsm_attack
from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import make_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu_torch.models.tiny import TinyCNN
model = TinyCNN(num_classes=8)
model.load_state_dict(torch.load(jobs["fgsm_weights"], weights_only=True))
model.eval().requires_grad_(False)
lf = make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD)
x_global = np.asarray(np.random.RandomState(0).uniform(0.2, 0.8, (8, 16, 16, 3)), np.float32)
x = process_local_batch(x_global, mesh)
succ = pred = 0
for xs in x.data_shards():
    y = torch.argmax(lf(xs), -1)
    x_adv = fgsm_attack(lf, xs, y, eps=8 / 255)
    succ += int((torch.argmax(lf(x_adv), -1) != y).sum())
    pred += int(y.sum())
tot = all_reduce_sum(torch.tensor([succ, pred], dtype=torch.int64))
if rank == 0:
    (out_dir / "fgsm.json").write_text(json.dumps({
        "counters": {"attack_success": int(tot[0]), "pred_sum": int(tot[1])},
        "n_processes": process_count(), "mesh": mesh.shape}))

# EOT-PGD and shot noise on this process's rows: the mix and the rates of
# both processes' shards
from image_recognition_adversarial_example_attack_tpu_torch.attacks.eot import make_eot_logits_fn
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
from image_recognition_adversarial_example_attack_tpu_torch.parallel import data_parallel as dp
y_global = torch.argmax(lf(torch.from_numpy(x_global)), -1).numpy()
eot_fn = make_eot_logits_fn(lf, generator_from_seed(1), n_samples=2, sigma=0.1)
adv = dp.sharded_pgd_linf_attack(eot_fn, x, process_local_batch(y_global, mesh), eps=8 / 255,
                                 alpha=2 / 255, steps=2, generator=generator_from_seed(7))
shot = dp.sharded_apply_corruption("shot_noise", x, 3, generator_from_seed(4))
torch.save({"eot_pgd": torch.cat(adv.data_shards()), "shot": torch.cat(shot.data_shards())},
           out_dir / f"draws_{rank}.pt")

# the grid CLI (the Engine's mesh spans both processes, one data row each)
for name, argv in jobs["grid"].items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert defense_experiments.main(argv) == 0
    (out_dir / f"grid_{name}_{rank}.txt").write_text(buf.getvalue())

# one PGD-AT step on this process's half of the batch (last: train_setup
# sets the training module's loss dtype to float64)
sys.path.insert(0, "tests")
from _torch_scaleout_helpers import train_setup
for name, cfg in jobs["train"].items():
    step, state, x_np, y_np, gen = train_setup(**cfg)
    xt, yt = process_local_batch(x_np, mesh), process_local_batch(y_np, mesh)
    state, metrics = step(state, xt, yt, gen)
    if rank == 0:
        torch.save({"params": state.params, "loss": metrics["loss"]},
                   out_dir / f"train_{name}.pt")
dist.destroy_process_group()
"""

TRAIN_CASES = {"plain": {}, "train_bn+grad_accum": {"train_bn": True, "grad_accum": 2},
               "smoothadv+train_bn+remat": {"train_bn": True, "remat": True,
                                            "noise_sigma": 0.25, "noise_samples": 2}}
GRID_ARGV = ["--attacks", "fgsm", "pgd", "--eps_list", "0.03137", "--viz_samples", "0"]
GRID_CASES = {"resident": [], "streamed": ["--max_batch", "3"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(code: str, *args: str) -> list[str]:
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {**os.environ, "ADV_TPU_COORDINATOR": f"127.0.0.1:{port}",
               "ADV_TPU_NUM_PROCESSES": "2", "ADV_TPU_PROCESS_ID": str(pid),
               "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """The worker pair's outputs: (output directory, the grid CLI's image
    directory and argv, the FGSM model)."""
    from _torch_cli_helpers import FAST, write_images
    from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
        from_jax_variables)

    root = tmp_path_factory.mktemp("two")
    fgsm_model = make_tiny(seed=0, image_size=16, num_classes=8)
    weights = root / "tiny.pt"
    torch.save(from_jax_variables(jax.tree_util.tree_map(np.asarray, fgsm_model[1]), "tiny"),
               weights)
    (root / "imgs").mkdir()
    images = write_images(root / "imgs", n=5, size=32)
    grid = {name: ["--image_dir", str(images), *GRID_ARGV, *FAST, *extra]
            for name, extra in GRID_CASES.items()}
    jobs = {"fgsm_weights": str(weights), "train": TRAIN_CASES,
            "grid": {name: [*argv, "--output_dir", str(root / f"two_{name}")]
                     for name, argv in grid.items()}}
    (root / "out").mkdir()
    _two_processes(_WORKER, str(root / "out"), json.dumps(jobs))
    return root / "out", grid, fgsm_model


def test_two_process_counters_match_single_process(two_processes):
    out, _, (model, variables) = two_processes
    got = json.loads((out / "fgsm.json").read_text())
    assert got["n_processes"] == 2
    assert got["mesh"] == {"data": 8, "model": 1}

    lf = jax_lf(model, variables, IMAGENET_MEAN, IMAGENET_STD)
    x = jnp.asarray(np.random.RandomState(0).uniform(0.2, 0.8, (8, 16, 16, 3)), jnp.float32)
    y = jnp.argmax(lf(x), -1)
    x_adv = fgsm_attack(lf, x, y, eps=8 / 255)
    want = {"attack_success": int(jnp.sum((jnp.argmax(lf(x_adv), -1) != y).astype(jnp.int32))),
            "pred_sum": int(jnp.sum(y.astype(jnp.int64)))}
    assert got["counters"] == want


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_process_pgd_at_step_matches_one_process(case, two_processes):
    out, _, _ = two_processes
    got = torch.load(out / f"train_{case}.pt", weights_only=True)
    step, state, x, y, gen = train_setup(**TRAIN_CASES[case])
    want, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= 1e-6
    for k, v in want.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_two_process_eot_pgd_and_shot_noise_equal_one_process(two_processes):
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
        make_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.eot import (
        make_eot_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.pgd import (
        pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.constants import (
        IMAGENET_MEAN as MEAN, IMAGENET_STD as STD)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        generator_from_seed)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.corruptions import (
        apply_corruption)
    from image_recognition_adversarial_example_attack_tpu_torch.models.tiny import TinyCNN

    out, _, _ = two_processes
    model = TinyCNN(num_classes=8)
    model.load_state_dict(torch.load(out.parent / "tiny.pt", weights_only=True))
    lf = make_logits_fn(model.eval().requires_grad_(False), MEAN, STD)
    x = torch.from_numpy(np.asarray(np.random.RandomState(0).uniform(0.2, 0.8, (8, 16, 16, 3)),
                                    np.float32))
    y = torch.argmax(lf(x), -1)
    eot_fn = make_eot_logits_fn(lf, generator_from_seed(1), n_samples=2, sigma=0.1)
    want = {"eot_pgd": pgd_linf_attack(eot_fn, x, y, eps=8 / 255, alpha=2 / 255, steps=2,
                                       generator=generator_from_seed(7)),
            "shot": apply_corruption("shot_noise", x, 3, generator_from_seed(4))}
    got = [torch.load(out / f"draws_{r}.pt", weights_only=True) for r in range(2)]
    for k, v in want.items():
        assert torch.equal(torch.cat([g[k] for g in got]), v), k


def test_two_process_grid_cli_prints_the_one_process_lines(two_processes, tmp_path):
    """The grid CLI joined to two gloo processes: the Engine's mesh spans
    both (one data row each), each process evaluates its rows of the padded
    batch, and the counters summed over the processes give the one-process
    summary lines; --max_batch streams chunks rounded to the data axis."""
    from _torch_cli_helpers import summary_lines
    from image_recognition_adversarial_example_attack_tpu_torch.cli import defense_experiments

    out, grid, _ = two_processes
    for name, argv in grid.items():
        buf = io.StringIO()
        torch.set_num_threads(1)
        with contextlib.redirect_stdout(buf):
            assert defense_experiments.main([*argv, "--output_dir", str(tmp_path / name)]) == 0
        want = summary_lines(buf.getvalue())
        assert len(want) == 2
        for rank in range(2):
            printed = (out / f"grid_{name}_{rank}.txt").read_text()
            assert summary_lines(printed) == want
            assert "Mesh: {'data': 2, 'model': 1}" in printed
            assert ("fixed chunks of 4" in printed) == (name == "streamed")


def test_make_dcn_mesh_single_process_fallback():
    mesh = make_dcn_mesh(n_model=2, devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.process_count == 1


def test_process_local_batch_single_process():
    mesh = make_dcn_mesh(devices=[torch.device("cpu")] * 8)
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    arr = process_local_batch(x, mesh)
    np.testing.assert_array_equal(arr.gather().numpy(), x)
    assert arr.sharding.spec == ("data",)
    assert [s.shape[0] for s in arr.data_shards()] == [1] * 8


def test_env_contract_unset_is_a_no_op(monkeypatch):
    for k in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
              distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    assert distributed.process_count() == 1
    t = torch.ones(3)
    assert distributed.all_reduce_sum(t) is t


def test_nccl_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: NCCL would start")
    monkeypatch.setenv(distributed.ENV_COORDINATOR, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "0")
    with pytest.raises(RuntimeError, match="NCCL"):
        maybe_initialize_distributed(backend="nccl")
    assert not torch.distributed.is_initialized()
