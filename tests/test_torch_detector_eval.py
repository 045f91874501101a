"""The port's detector comparison (eval/detector_eval.py, the streamed score
functions of eval/streaming.py, cli/detector_eval.py) against the JAX
package's on the CPU.

- ``roc_auc`` / ``tpr_at_fpr`` equal to JAX's on random and tied score
  vectors; ``summary_table`` the same bytes;
- ``evaluate_detector_cell`` for the three detectors on float32 resnet_tiny
  (bridged weights; the Mahalanobis Gaussians JAX's fit): the stacked
  scores within ``TOL`` relative (Mahalanobis: of the largest score; the
  float32 quadratic form's rounding scales with it), the cells equal;
- ``stream_clean_scores`` / ``stream_detector_scores`` equal to the
  resident scores of each chunk;
- the CLI on FGSM (deterministic) on one msgpack of ibp_tiny weights, 16
  PNGs at 32x32, resident and streamed: the JSON rows within ``TOL`` and the
  same table text; then the port alone on the two streamed edge cases (an
  all-unreadable first chunk; the calibration chunk being the last one).
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from _torch_port_helpers import jax_zoo_init_once, module_time_limit, one_thread, time_limit  # noqa: F401 (autouse)
from _torch_port_helpers import flax_resnet, port_resnet, uncast_fns
from _torch_scaleout_helpers import seeded_tree
from image_recognition_adversarial_example_attack_tpu.attacks import api as jax_api
from image_recognition_adversarial_example_attack_tpu.cli import detector_eval as jax_cli
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.defenses import detector as jax_det
from image_recognition_adversarial_example_attack_tpu.defenses import mahalanobis as jax_mahal
from image_recognition_adversarial_example_attack_tpu.eval import detector_eval as jax_de
from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
    AttackParams, make_logits_fn, run_attack)
from image_recognition_adversarial_example_attack_tpu_torch.cli import detector_eval as cli
from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
    MahalanobisParams, feature_score, mahalanobis_score, make_features_fn, squeezing_score)
from image_recognition_adversarial_example_attack_tpu_torch.eval import detector_eval as de
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
    make_placer, stream_clean_scores, stream_detector_scores)
from image_recognition_adversarial_example_attack_tpu_torch.models import ibp as port_ibp
from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

TOL = 1e-6  # float32 scores, relative to max(1, |score|)
DETECTORS = ("feature", "squeezing", "mahalanobis")


def _close(a, b, tol=TOL, scale=None):
    """|a - b| <= tol * max(1, |b|) elementwise, or tol * scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    bound = tol * (np.maximum(1.0, np.abs(b)) if scale is None else scale)
    np.testing.assert_array_less(np.abs(a - b), bound + 1e-300)


# ---------------------------------------------------------------------------
# the ROC arithmetic

def _score_pairs():
    rs = np.random.RandomState(0)
    return {
        "random": (rs.randn(40), rs.randn(25) + 0.3),
        "ties": (rs.randint(0, 4, 30).astype(np.float64), rs.randint(1, 5, 21).astype(np.float64)),
        "all_equal": (np.ones(10), np.ones(7)),
        "separated": (np.r_[0.0, 1.0, 2.0], np.r_[3.0, 4.0]),
        "reversed": (np.r_[3.0, 4.0], np.r_[0.0, 1.0]),
        "one_each": (np.r_[1.0], np.r_[1.0]),
        "float32": (rs.rand(33).astype(np.float32), rs.rand(12).astype(np.float32)),
    }


@pytest.mark.parametrize("case", sorted(_score_pairs()))
def test_roc_auc_and_tpr_at_fpr_equal_jaxs(case):
    neg, pos = _score_pairs()[case]
    assert de.roc_auc(neg, pos) == jax_de.roc_auc(neg, pos)
    for fpr in (0.0, 0.05, 0.1, 0.5, 1.0):
        assert de.tpr_at_fpr(neg, pos, fpr) == jax_de.tpr_at_fpr(neg, pos, fpr)
    thr = float(np.median(neg))
    ours = de.cell_from_scores(neg, pos, thr, detector="d", attack="a")
    theirs = jax_de.cell_from_scores(neg, pos, thr, detector="d", attack="a")
    assert vars(ours) == vars(theirs)


def test_roc_auc_rejects_an_empty_side():
    with pytest.raises(ValueError, match="at least one"):
        de.roc_auc(np.r_[1.0], np.asarray([]))


def test_summary_table_is_the_same_bytes():
    rs = np.random.RandomState(1)
    cells = [(a, d, rs.rand(8), rs.rand(8) + 0.2, float(rs.rand()))
             for a in ("fgsm", "pgd", "apgd_dlr") for d in DETECTORS]
    ours = [de.cell_from_scores(c, v, t, detector=d, attack=a) for a, d, c, v, t in cells]
    theirs = [jax_de.cell_from_scores(c, v, t, detector=d, attack=a) for a, d, c, v, t in cells]
    assert de.summary_table(ours) == jax_de.summary_table(theirs)
    assert de.summary_table([]) == jax_de.summary_table([])


# ---------------------------------------------------------------------------
# the stacked cell on resnet_tiny

@pytest.fixture(scope="module")
def nets():
    module, variables = flax_resnet("resnet_tiny", np.float32, num_classes=10, seed=11)
    model = port_resnet("resnet_tiny", variables, np.float32, num_classes=10)
    return {
        "jax": (jax_api.make_logits_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD),
                jax_det.make_features_fn(module, variables, IMAGENET_MEAN, IMAGENET_STD)),
        "port": (make_logits_fn(model, IMAGENET_MEAN, IMAGENET_STD),
                 make_features_fn(model, IMAGENET_MEAN, IMAGENET_STD)),
    }


@pytest.mark.parametrize("detector", DETECTORS)
def test_evaluate_detector_cell_equals_jaxs(nets, detector):
    rs = np.random.RandomState(4)
    x = rs.uniform(0.05, 0.95, (12, 32, 32, 3)).astype(np.float32)
    x_adv = np.clip(x + rs.choice([-0.03, 0.03], x.shape), 0, 1).astype(np.float32)
    (jl, jf), (pl, pf) = nets["jax"], nets["port"]
    if detector == "feature":
        j_score, p_score = (lambda xx: jax_det.feature_score(jf, xx),
                            lambda xx: feature_score(pf, xx))
    elif detector == "squeezing":
        j_score, p_score = (lambda xx: jax_det.squeezing_score(jl, xx),
                            lambda xx: squeezing_score(pl, xx))
    else:
        # fitted on more images (160) than the stage-3 width (128), so that
        # the float32 precision matrix is well conditioned
        x_fit = jnp.asarray(rs.uniform(0.05, 0.95, (160, 32, 32, 3)).astype(np.float32))
        feats = jax.jit(jf)(x_fit)
        params = jax_mahal.fit_mahalanobis(jax_mahal.pool_features(feats),
                                           jnp.argmax(jax.jit(jl)(x_fit), -1), 10)
        mp = MahalanobisParams(torch.from_numpy(np.array(params.mean)),
                               torch.from_numpy(np.array(params.precision)))
        j_score = lambda xx: jax_mahal.mahalanobis_score(jf, xx, params)  # noqa: E731
        p_score = lambda xx: mahalanobis_score(pf, xx, mp)  # noqa: E731
    stacked = np.concatenate([x, x_adv])
    want_scores = np.asarray(jax.jit(j_score)(jnp.asarray(stacked)))
    with torch.no_grad():
        got_scores = p_score(torch.from_numpy(stacked)).numpy()
    # a float32 quadratic form (Mahalanobis) rounds to its largest terms: its
    # scores are held within TOL of the largest score
    _close(got_scores, want_scores,
           scale=np.abs(want_scores).max() if detector == "mahalanobis" else None)
    thr = float(np.median(want_scores))
    want = jax_de.evaluate_detector_cell(j_score, jnp.asarray(x), jnp.asarray(x_adv), thr,
                                         detector=detector, attack="fgsm")
    got = de.evaluate_detector_cell(p_score, torch.from_numpy(x), torch.from_numpy(x_adv), thr,
                                    detector=detector, attack="fgsm")
    assert vars(got) == vars(want)


def test_mahalanobis_scores_equal_jaxs_in_float64():
    """The float32 check above holds Mahalanobis scores within TOL of the
    largest; on other weights that rounding reaches TOL.  With float64
    features and JAX's fitted parameters in float64, the two packages'
    quadratic forms agree to rounding, whatever the draw."""
    with jax.enable_x64():
        module, variables = flax_resnet("resnet_tiny", np.float64, num_classes=10, seed=11)
        model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
        fns = uncast_fns(module, variables, model)
        (jl, jf), pf = fns["jax"], fns["port"][1]
        rs = np.random.RandomState(4)
        x_fit = jnp.asarray(rs.uniform(0.05, 0.95, (160, 32, 32, 3)))
        params = jax_mahal.fit_mahalanobis(jax_mahal.pool_features(jax.jit(jf)(x_fit)),
                                           jnp.argmax(jax.jit(jl)(x_fit), -1), 10)
        params = type(params)(mean=jnp.asarray(params.mean, jnp.float64),
                              precision=jnp.asarray(params.precision, jnp.float64))
        x = rs.uniform(0.05, 0.95, (24, 32, 32, 3))
        want = np.asarray(jax.jit(lambda xx: jax_mahal.mahalanobis_score(jf, xx, params))(
            jnp.asarray(x)))
    mp = MahalanobisParams(torch.from_numpy(np.array(params.mean)),
                           torch.from_numpy(np.array(params.precision)))
    with torch.no_grad():
        got = mahalanobis_score(pf, torch.from_numpy(x), mp).numpy()
    assert got.dtype == want.dtype == np.float64
    _close(got, want, tol=1e-12, scale=np.abs(want).max())


# ---------------------------------------------------------------------------
# the streamed score functions against resident runs of each chunk

def _pngs(d, n, size, seed=0, bad=0):
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(bad):  # '_' sorts before letters: these lead
        (d / f"_bad_{i}.png").write_text("not an image")
    for i in range(n):
        Image.fromarray((rs.rand(size, size, 3) * 255).astype(np.uint8)).save(d / f"im_{i:02d}.png")
    return sorted(d.iterdir())


@pytest.mark.parametrize("attack", ["fgsm", "pgd"])
def test_streamed_scores_equal_resident_chunks(tmp_path, attack):
    """5 images in chunks of 2: each chunk's scores are the resident scores
    of its images (the tail chunk padded by repeating rows), the attack of
    chunk ``step`` drawing from ``chunk_generator(seed, cell, step)``."""
    paths = _pngs(tmp_path, 5, 40)
    b = zoo.load_model("resnet_tiny", device="cpu")
    lf = make_logits_fn(b.model, b.mean, b.std)
    ff = make_features_fn(b.model, b.mean, b.std)
    fns = {"feature": lambda xx: feature_score(ff, xx),
           "squeezing": lambda xx: squeezing_score(lf, xx)}
    params = AttackParams(steps=2)

    def pred(xx):
        return torch.argmax(lf(xx), -1)

    def atk(xx, yy, g):
        return run_attack(attack, lf, xx, yy, params, generator=g)

    kw = {"chunk_size": 2, "place": make_placer("cpu"), "size": 32}
    clean = stream_clean_scores(fns, paths, **kw)
    cache: dict = {}
    got = stream_detector_scores(atk, fns, pred, paths, seed=3, cell_id="c", clean_cache=cache,
                                 **kw)
    assert got["count"] == 5 and set(cache) == {"__sig__", 0, 1, 2}
    x_all = torch.from_numpy(load_image_batch(paths, size=32))
    want_clean = {d: [] for d in fns}
    want_adv = {d: [] for d in fns}
    want_succ = []
    for step in range(3):
        x = x_all[2 * step:2 * step + 2]
        n = x.shape[0]
        x = torch.cat([x, x[:1]]) if n < 2 else x  # the pipeline's tail padding
        with torch.no_grad():
            y = pred(x)
        x_adv = atk(x, y, chunk_generator(3, "c", step))
        with torch.no_grad():
            want_succ.append((pred(x_adv) != y).numpy()[:n])
            for d, fn in fns.items():
                want_clean[d].append(fn(x).numpy()[:n])
                want_adv[d].append(fn(x_adv).numpy()[:n])
    np.testing.assert_array_equal(got["succ"], np.concatenate(want_succ))
    for d in fns:
        _close(clean[d], np.concatenate(want_clean[d]))
        _close(got["adv"][d], np.concatenate(want_adv[d]))
    with pytest.raises(ValueError, match="clean_cache"):
        stream_detector_scores(atk, fns, pred, paths[:4], seed=3, cell_id="c",
                               clean_cache=cache, **kw)


def test_stream_clean_scores_refuses_unreadable_sets(tmp_path):
    paths = _pngs(tmp_path, 0, 8, bad=3)
    with pytest.raises(SystemExit, match="no loadable images"):
        stream_clean_scores({"f": lambda xx: xx.sum((1, 2, 3))}, paths, chunk_size=2,
                            place=make_placer("cpu"), size=32)


# ---------------------------------------------------------------------------
# the CLI

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("detector_cli")
    images = root / "imgs"
    _pngs(images, 16, 40, seed=2)
    rs = np.random.RandomState(0)
    v = seeded_tree(port_ibp.ibp_tiny(), "ibp")
    v = {"params": {k: {kk: np.asarray(vv) + (0.05 * rs.randn(*vv.shape)).astype(np.float32)
                        for kk, vv in d.items()} for k, d in v["params"].items()}}
    weights = root / "ibp_tiny.msgpack"
    weights.write_bytes(serialization.to_bytes(v))
    return {"root": root, "images": images,
            "base": ["--image_dir", str(images), "--model", "ibp_tiny", "--weights", str(weights)]}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_parser_keeps_the_jax_flags():
    ours = {a.dest: (a.default, a.choices) for a in cli.build_parser()._actions}
    theirs = {a.dest: (a.default, a.choices) for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == set()
    assert {k for k in theirs if ours[k] != theirs[k]} == set()
    assert cli.ATTACK_CHOICES == [a.choices for a in jax_cli.build_parser()._actions
                                  if a.dest == "attacks"][0]


def _table(text: str) -> str:
    return text.split("DETECTOR COMPARISON\n" + "=" * 62 + "\n")[1].split("\n\nWrote")[0]


@pytest.mark.parametrize("max_batch", ["0", "6"], ids=["resident", "streamed"])
def test_cli_on_fgsm_is_the_jax_clis(setup, max_batch):
    """FGSM draws nothing: the rows, the table and the threshold lines
    agree.  Streamed, 16 images in chunks of 6 (the tail chunk of 4)."""
    out = {}
    for who, main, extra in (("ours", cli.main, ["--device", "cpu"]), ("theirs", jax_cli.main, [])):
        path = setup["root"] / f"det_{who}_{max_batch}.json"
        text = _run(main, [*setup["base"], "--attacks", "fgsm", "--eps", "0.1", "--max_batch",
                           max_batch, "--output_json", str(path), *extra])
        out[who] = (text, json.loads(path.read_text()))
    (text_o, rows_o), (text_t, rows_t) = out["ours"], out["theirs"]
    assert _table(text_o) == _table(text_t)
    assert [r["detector"] for r in rows_o] == list(DETECTORS)
    for ro, rt in zip(rows_o, rows_t):
        assert set(ro) == set(rt)
        for k in ro:
            if isinstance(ro[k], float):
                assert abs(ro[k] - rt[k]) <= TOL, (k, ro, rt)
            else:
                assert ro[k] == rt[k]
    lines = [[ln.split("=")[0] for ln in t.splitlines() if "threshold=" in ln]
             for t in (text_o, text_t)]
    assert lines[0] == lines[1] and len(lines[0]) == 3
    if max_batch != "0":
        assert "STREAMING fixed chunks" in text_o and "(16 images)" in text_o


@pytest.mark.parametrize("case", ["unreadable_first_chunk", "calibration_chunk_is_last"])
def test_cli_streamed_calibration_edge_cases(setup, tmp_path, case):
    """Four unreadable files lead the list (one chunk of 4): the calibration
    set is the first decodable chunk; where it is also the last one,
    nothing is left to stream and its scores alone calibrate."""
    n_good = 6 if case == "unreadable_first_chunk" else 4
    d = tmp_path / "imgs"
    _pngs(d, n_good, 40, seed=3, bad=4)
    path = tmp_path / "det.json"
    base = [a if a != str(setup["images"]) else str(d) for a in setup["base"]]
    text = _run(cli.main, [*base, "--device", "cpu", "--attacks", "fgsm", "--eps", "0.1",
                           "--max_batch", "4", "--output_json", str(path)])
    assert "STREAMING fixed chunks" in text
    assert f"calibrated on all {n_good} clean scores" in text
    assert f"({n_good} images)" in text
    rows = json.loads(path.read_text())
    assert [r["detector"] for r in rows] == list(DETECTORS)
    assert all(0.0 <= r["auc"] <= 1.0 for r in rows)
