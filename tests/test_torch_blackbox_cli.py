"""The robust_eval and query_curves CLIs of the port (cli/robust_eval.py,
cli/query_curves.py) against the JAX package's on the CPU.

Both packages load the same resnet_tiny weights from one Flax msgpack file
and read the same three images.  Their random draws differ, so the counts
may differ; the parsers, the console formats, the JSON keys and every
number that does not depend on a draw (the budgets, the query axes, the
counts of images) agree.  Then the port alone: ``--save_adv_dir``,
``--plot``, streaming past ``--max_batch``, and ``--cifar10_dir`` refused
before any device work.
"""

import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
from flax import serialization
from PIL import Image

from _torch_cli_helpers import one_thread, write_images  # noqa: F401 (one_thread: autouse)
from _torch_port_helpers import flax_resnet
from image_recognition_adversarial_example_attack_tpu.cli import query_curves as jax_qc_cli
from image_recognition_adversarial_example_attack_tpu.cli import robust_eval as jax_re_cli
from image_recognition_adversarial_example_attack_tpu_torch.cli import query_curves, robust_eval
from image_recognition_adversarial_example_attack_tpu_torch.eval import query_curves as qc

RE_CUT = ["--apgd_steps", "2", "--square_steps", "4", "--deepfool_steps", "2", "--fab_steps",
          "2", "--n_target_classes", "2", "--eot_samples", "2", "--eps_list", "0.01", "0.03"]
QC_CUT = ["--max_queries", "12", "--est_samples", "2", "--checkpoints", "4", "8", "12"]
RE_LINE = re.compile(r"^eps=\d\.\d{5}: robust_acc=\d\.\d{3} \((\w+ \d+/\d+ ?)+\)  \[\d+\.\ds\]$")
RE_KEYS = {"protocol", "norm", "eot_samples", "eot_sigma", "apgd_steps", "square_steps",
           "deepfool_steps", "fab_steps", "n_target_classes", "results"}
ARMS = {"lite": ("apgd", "square", "deepfool"), "standard": ("apgd_ce", "apgd_t", "fab", "square"),
        "rand": ("apgd_ce_eot", "apgd_dlr_eot", "square")}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("blackbox_cli")
    images = root / "imgs"
    images.mkdir()
    write_images(images, n=3, size=48)
    _, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, size=224, seed=1)
    weights = root / "resnet_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(variables))
    base = ["--image_dir", str(images), "--model", "resnet_tiny", "--weights", str(weights)]
    return {"root": root, "images": images, "base": base}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("which", ["robust_eval", "query_curves"])
def test_parser_keeps_the_jax_flags(which):
    ours_cli, theirs_cli = {"robust_eval": (robust_eval, jax_re_cli),
                            "query_curves": (query_curves, jax_qc_cli)}[which]
    ours = {a.dest: a.default for a in ours_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in theirs_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) - set(ours) == set()
    assert {k for k in ours if k in theirs and ours[k] != theirs[k]} == set()
    theirs = {a.dest: a.choices for a in theirs_cli.build_parser()._actions}
    assert {a.dest: a.choices for a in ours_cli.build_parser()._actions
            if a.dest != "device"} == theirs


def _robust_lines(text: str) -> tuple[str, list[str]]:
    lines = text.splitlines()
    head = next(ln for ln in lines if " images; protocol=" in ln)
    return head, [ln for ln in lines if ln.startswith("eps=")]


def test_robust_eval_console_and_json_are_the_jax_clis(setup):
    out = {}
    for who, main, extra in (("ours", robust_eval.main, ["--device", "cpu"]),
                             ("theirs", jax_re_cli.main, [])):
        path = setup["root"] / f"re_{who}.json"
        text = _run(main, [*setup["base"], *RE_CUT, "--output", str(path), *extra])
        out[who] = (text, json.loads(path.read_text()))
    (text_o, json_o), (text_t, json_t) = out["ours"], out["theirs"]
    head_o, lines_o = _robust_lines(text_o)
    head_t, lines_t = _robust_lines(text_t)
    # the same arms' description; the parenthesis says how each package runs
    assert head_o.split(" (")[0] == head_t.split(" (")[0] == (
        "3 images; protocol=lite; norm=linf; arms: apgd-2 square-4 deepfool-2")
    assert len(lines_o) == len(lines_t) == 2
    for ln_o, ln_t in zip(lines_o, lines_t):
        assert RE_LINE.match(ln_o) and RE_LINE.match(ln_t), (ln_o, ln_t)
        assert ln_o.split(":")[0] == ln_t.split(":")[0]
        assert re.findall(r"(\w+) \d+/3", ln_o) == re.findall(r"(\w+) \d+/3", ln_t) == [
            "apgd", "square", "deepfool"]
    assert set(json_o) == set(json_t) == RE_KEYS
    assert {k: v for k, v in json_o.items() if k != "results"} == {
        k: v for k, v in json_t.items() if k != "results"}
    for row_o, row_t in zip(json_o["results"], json_t["results"]):
        assert set(row_o) == set(row_t)
        assert row_o["eps"] == row_t["eps"] and row_o["count"] == row_t["count"] == 3


@pytest.mark.parametrize("protocol", ["lite", "standard", "rand"])
def test_robust_eval_saves_the_worst_cases_and_plots(setup, protocol):
    root = setup["root"] / f"re_{protocol}"
    text = _run(robust_eval.main, [*setup["base"], *RE_CUT, "--protocol", protocol,
                                   "--device", "cpu", "--output", str(root / "r.json"),
                                   "--save_adv_dir", str(root / "adv"),
                                   "--plot", str(root / "r.png")])
    data = json.loads((root / "r.json").read_text())
    assert data["protocol"] == protocol and len(data["results"]) == 2
    for row in data["results"]:
        assert set(row) == {"eps", "robust_accuracy", "count",
                            *(f"success_{a}" for a in ARMS[protocol])}
        assert 0.0 <= row["robust_accuracy"] <= 1.0 and row["count"] == 3
        saved = sorted((root / "adv" / f"eps_{row['eps']:.5f}").glob("*.png"))
        assert [p.name[:9] for p in saved] == ["adv_0000_", "adv_0001_", "adv_0002_"]
    assert f"Wrote {root / 'r.png'}" in text
    with Image.open(root / "r.png") as im:
        assert im.size[0] > 500 and im.mode == "RGB"


def test_robust_eval_streams_past_max_batch(setup):
    """Three images in chunks of two: the JSON of the one-batch layout (the
    evaluated count), ``--save_adv_dir`` refused with the JAX CLI's note."""
    root = setup["root"] / "re_stream"
    root.mkdir()
    text = _run(robust_eval.main, [*setup["base"], *RE_CUT, "--device", "cpu", "--max_batch",
                                   "2", "--output", str(root / "s.json"),
                                   "--save_adv_dir", str(root / "adv")])
    assert "Streaming evaluation: 3 images in fixed chunks of 2 (constant memory)" in text
    assert "(--save_adv_dir ignored: streaming mode keeps x_adv" in text
    assert not (root / "adv").exists()
    data = json.loads((root / "s.json").read_text())
    assert set(data) == RE_KEYS and [r["count"] for r in data["results"]] == [3, 3]
    assert all(RE_LINE.match(ln) for ln in _robust_lines(text)[1])


def test_robust_eval_refuses_cifar10_before_any_device_work(setup):
    """Asked for the card (absent here): the refusal comes first."""
    with pytest.raises(SystemExit, match="Queue 1 item 6"):
        robust_eval.main([*setup["base"], "--cifar10_dir", str(setup["root"]),
                          "--device", "cuda"])


def _qc_table(text: str) -> tuple[str, dict[str, list[str]]]:
    lines = text.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("attack "))
    rows = {}
    for ln in lines[head + 2:]:
        if not ln.strip():
            break
        rows[ln.split()[0]] = ln
    return lines[head], rows


def test_query_curves_table_and_json_are_the_jax_clis(setup):
    attacks = ["square", "simba", "nes", "bandits"]
    out = {}
    for who, main, extra in (("ours", query_curves.main, ["--device", "cpu"]),
                             ("theirs", jax_qc_cli.main, [])):
        path = setup["root"] / f"qc_{who}.json"
        text = _run(main, [*setup["base"], *QC_CUT, "--attacks", *attacks,
                           "--output", str(path), *extra])
        out[who] = (text, json.loads(path.read_text()))
    (text_o, json_o), (text_t, json_t) = out["ours"], out["theirs"]
    head_o, rows_o = _qc_table(text_o)
    head_t, rows_t = _qc_table(text_t)
    assert head_o == head_t == query_curves.table_header([4, 8, 12])
    assert list(rows_o) == list(rows_t) == attacks
    for name in attacks:
        # the ASR columns, the median (a number or '—') and the seconds
        assert len(rows_o[name].split()) == len(rows_t[name].split()) == 1 + 3 + 2
    assert "3 images; eps=0.03137; max budget 12 queries" in text_o
    assert set(json_o) == set(json_t) == {"count", "eps", "max_queries", "labels", "curves"}
    assert {k: json_o[k] for k in ("count", "eps", "max_queries", "labels")} == {
        k: json_t[k] for k in ("count", "eps", "max_queries", "labels")}
    for c_o, c_t in zip(json_o["curves"], json_t["curves"]):
        assert set(c_o) == set(c_t)
        assert c_o["attack"] == c_t["attack"] and c_o["queries"] == c_t["queries"]
        assert len(c_o["asr"]) == len(c_t["asr"])


def test_query_curves_row_prints_a_dash_without_a_median():
    curve = qc.assemble_curve("square", np.zeros(3, np.int64), 2, np.full(2, -1), per_step=1,
                              init_q=2, steps=3)
    row = query_curves.table_row("square", curve, [3, 5], 1.25)
    assert row == f"{'square':<10} {0.0:<8.3f} {0.0:<8.3f} {'—':>9} {1.25:>6.1f}s"


def test_query_curves_stream_past_max_batch(setup):
    """Three images in chunks of two: the streamed JSON has the one-batch
    keys plus ``streamed`` and ``max_batch``, the same query axes, and the
    count of images."""
    out = {}
    for who, extra in (("one", []), ("streamed", ["--max_batch", "2"])):
        path = setup["root"] / f"qc_port_{who}.json"
        text = _run(query_curves.main, [*setup["base"], *QC_CUT, "--attacks", "square",
                                        "spsa", "--device", "cpu", "--output", str(path),
                                        *extra])
        out[who] = (text, json.loads(path.read_text()))
    text, streamed = out["streamed"]
    one = out["one"][1]
    assert "3 images STREAMED in fixed chunks of 2 (constant memory)" in text
    assert set(streamed) - set(one) == {"streamed", "max_batch"}
    assert streamed["streamed"] is True and streamed["max_batch"] == 2
    assert streamed["count"] == one["count"] == 3
    for c_s, c_1 in zip(streamed["curves"], one["curves"]):
        assert c_s["queries"] == c_1["queries"] and len(c_s["asr"]) == len(c_1["asr"])
        assert all(0.0 <= a <= 1.0 for a in c_s["asr"])
