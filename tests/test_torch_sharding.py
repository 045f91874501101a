"""The port's scale-out layer on the CPU (parallel/mesh.py's tensor-parallel
rule, parallel/tensor_parallel.py, parallel/data_parallel.py, the grid CLI
on a mesh) against the JAX package's (tests/test_sharding.py).

- ``tensor_parallel_spec`` cuts exactly the parameters JAX's rule cuts,
  along the torch axes the converter maps JAX's to, with JAX's replication
  fallback, for all 18 zoo names (JAX's shapes from ``jax.eval_shape``, the
  port's models on the meta device); per-slot memory is half on the
  dominant tensors.
- Tensor parallelism on a ``[cpu] * 8`` 4x2 mesh: ViT, ResNet, Swin, VGG,
  DenseNet and EfficientNet logits and input gradients equal the replicated
  model's; the logits equal JAX's on its 8 virtual devices, and ViT's and
  ResNet's input gradients too (float64; JAX's TestTPAllFamilies holds the
  other four by their forward).
- The data axis: PGD, UAP and the eval cell sharded over the mesh equal the
  one-device run and JAX's sharded run (float64; JAX's draws fed through
  the port's draw functions); the eval cell of every other grid attack and
  the random defenses sharded equal the one-device run (each shard draws
  its rows of the unsharded draws; a draw that cannot route a shard's
  generator raises); the grid CLI on a mesh prints the one-device run's
  summary lines.
"""

import io
import json
from contextlib import redirect_stdout
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from _torch_cli_helpers import FAST, one_thread, summary_lines, write_images  # noqa: F401
from _torch_port_helpers import _perturb as port_perturb
from _torch_port_helpers import port_resnet, uncast_fns
from _torch_scaleout_helpers import seeded_variables
from image_recognition_adversarial_example_attack_tpu.attacks.pgd import (
    pgd_linf_attack as jax_pgd)
from image_recognition_adversarial_example_attack_tpu.attacks.uap import uap_attack as jax_uap
from image_recognition_adversarial_example_attack_tpu.core.constants import (
    IMAGENET_MEAN, IMAGENET_STD)
from image_recognition_adversarial_example_attack_tpu.core.normalize import (
    normalize_batch as jax_normalize)
from image_recognition_adversarial_example_attack_tpu.models import resnet as jax_resnet
from image_recognition_adversarial_example_attack_tpu.models import zoo as jax_zoo
from image_recognition_adversarial_example_attack_tpu.parallel import mesh as jax_mesh
from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd
from image_recognition_adversarial_example_attack_tpu_torch.attacks.pgd import pgd_linf_attack
from image_recognition_adversarial_example_attack_tpu_torch.attacks.uap import uap_attack
from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
    normalize_batch as port_normalize)
from image_recognition_adversarial_example_attack_tpu_torch.cli.common import ATTACK_CHOICES
from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
    generator_from_seed, shard_generators)
from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
    STAT_KEYS, DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch)
from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import make_placer
from image_recognition_adversarial_example_attack_tpu_torch.models import convert, zoo
from image_recognition_adversarial_example_attack_tpu_torch.models import resnet as port_models
from image_recognition_adversarial_example_attack_tpu_torch.parallel import (
    data_parallel as dp, make_mesh, shard_batch, shard_model_variables)
from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import (
    _torch_shards, parameter_specs, tensor_parallel_spec)
from image_recognition_adversarial_example_attack_tpu_torch.parallel.tensor_parallel import (
    shard_fractions, tensor_parallel_model)

CPU = torch.device("cpu")
EPS, ALPHA = 8 / 255, 2 / 255
TOL = 1e-10


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(n_data=4, n_model=2, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jax_mesh.make_mesh(n_data=4, n_model=2)


# ---------------------------------------------------------------------------
# the rule, against JAX's, on every zoo name at full width
# ---------------------------------------------------------------------------

def _jax_cut(shapes, n_model: int) -> dict:
    """JAX's shard_model_variables on abstract shapes: its device_put
    replaced by a recorder of the sharding it asks for."""
    mesh = jax_mesh.make_mesh(n_data=8 // n_model, n_model=n_model)
    with mock.patch.object(jax_mesh.jax, "device_put", lambda leaf, sh: (leaf, sh)):
        placed = jax_mesh.shard_model_variables(shapes, mesh, tensor_parallel=True)
    out = {}
    for path, (leaf, sh) in jax.tree_util.tree_flatten_with_path(
            placed, is_leaf=lambda t: isinstance(t, tuple))[0]:
        spec = tuple(sh.spec)
        if "model" in spec:
            out[tuple(p.key for p in path)] = (leaf.shape, spec.index("model"))
    return out


def _jax_cut_in_torch(cut: dict, shapes, family: str) -> set:
    """JAX's cut leaves carried through the converter: every cut leaf's
    axis halved, the one torch axis that changes."""
    def meta(path, leaf):
        shape = list(leaf.shape)
        key = tuple(p.key for p in path)
        if key in cut:
            shape[cut[key][1]] //= 2
        return torch.empty(shape, device="meta")

    full = convert.from_jax_variables(
        jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes), family)
    halved = convert.from_jax_variables(jax.tree_util.tree_map_with_path(meta, shapes), family)
    out = set()
    for k, t in halved.items():
        dims = [d for d in range(t.ndim) if t.shape[d] != full[k].shape[d]]
        assert len(dims) <= 1, k
        if dims:
            out.add((k, dims[0]))
    return out


def _port_cut(name: str, n_model: int) -> set:
    with torch.device("meta"):
        model = zoo.build_model(name)
    out = set()
    for key, (spec, leaf) in parameter_specs(model, zoo.model_family(name), n_model).items():
        if spec is not None:
            _, dim, _ = _torch_shards(model.state_dict()[key], spec, leaf, n_model)
            out.add((key, dim))
    return out


@pytest.mark.parametrize("name", jax_zoo.list_models())
def test_tensor_parallel_spec_cuts_jaxs_parameters_on_the_mapped_axes(name):
    assert jax_zoo.list_models() == zoo.list_models()
    size = jax_zoo.model_meta(name)["input_size"]
    shapes = jax.eval_shape(jax_zoo._REGISTRY[name](jnp.float32).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    family = zoo.model_family(name)
    for n_model in (2, 4):
        want = _jax_cut_in_torch(_jax_cut(shapes, n_model), shapes, family)
        assert _port_cut(name, n_model) == want, (name, n_model)
    if name in ("resnet50", "vit_b_16", "vgg19", "swin_t", "densenet121"):
        assert want  # these families cut something at n_model 4


def test_the_rule_keeps_jaxs_text():
    """The spec function returns JAX's specs on JAX's paths (tuples, as
    JAX's PartitionSpec is one)."""
    cases = [(("params", "fc", "kernel"), (2048, 1000)),
             (("params", "encoder_layer_0", "self_attention", "qkv", "kernel"), (768, 3, 12, 64)),
             (("params", "encoder_layer_0", "self_attention", "qkv", "bias"), (3, 12, 64)),
             (("params", "encoder_layer_0", "self_attention", "out", "kernel"), (768, 768)),
             (("params", "encoder_layer_0", "mlp_linear_1", "bias"), (3072,)),
             (("params", "layer2_0", "conv2", "kernel"), (3, 3, 128, 128)),
             (("params", "conv1", "kernel"), (7, 7, 3, 64)),
             (("batch_stats", "layer1_0", "bn1", "mean"), (64,))]
    for path, shape in cases:
        leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
        want = jax_mesh.tensor_parallel_spec(tuple(jax.tree_util.DictKey(k) for k in path), leaf)
        got = tensor_parallel_spec(path, torch.empty(shape, device="meta"))
        assert (got is None and want is None) or tuple(got) == tuple(want), path


def test_per_slot_memory_is_half_on_the_dominant_tensors(mesh8):
    from image_recognition_adversarial_example_attack_tpu_torch.models.vit import vit_tiny

    model = zoo.random_init_(vit_tiny(num_classes=8))
    placed = shard_model_variables(model, mesh8, tensor_parallel=True, family="vit")
    block = "encoder.layers.encoder_layer_0"
    for key in (f"{block}.self_attention.in_proj_weight", f"{block}.mlp.0.weight",
                f"{block}.mlp.3.weight", "heads.head.weight"):
        pv = placed[key]
        assert len(pv.shards) == 8
        assert all(2 * s.numel() == model.state_dict()[key].numel() for s in pv.shards), key
        assert torch.equal(pv.shards[0], pv.shards[2])  # every data row holds slot 0's shard
    # the qkv shard of slot 1 is its heads' rows inside each of q, k and v
    qkv = model.state_dict()[f"{block}.self_attention.in_proj_weight"]
    hd = qkv.shape[1] // 2
    rows = torch.cat([torch.arange(p * 2 * hd + hd, (p + 1) * 2 * hd) for p in range(3)])
    assert torch.equal(placed[f"{block}.self_attention.in_proj_weight"].shards[1], qkv[rows])
    assert placed["conv_proj.weight"].spec is None
    assert placed[f"{block}.ln_1.weight"].spec is None
    replicated = shard_model_variables(model, mesh8, tensor_parallel=False, family="vit")
    assert all(pv.spec is None for pv in replicated.values())


# ---------------------------------------------------------------------------
# tensor-parallel execution, against the replicated model and JAX's
# ---------------------------------------------------------------------------

FAMILIES = {  # test name -> (family, constructor, the head whose output is the logits)
    "vit": ("vit", "vit_tiny", "head"),
    "resnet": ("resnet", "resnet_tiny", "fc"),
    "swin": ("swin", "swin_tiny_test", "head"),
    "vgg": ("vgg", "vgg_tiny", "classifier_6"),
    "densenet": ("densenet", "densenet_tiny", "classifier"),
    "efficientnet": ("efficientnet", "efficientnet_tiny", "classifier"),
}


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float64)
        if k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            v = rng.uniform(0.7, 1.3, v.shape)
        elif k in ("mean", "bias", "class_token"):
            v = v + rng.randn(*v.shape) * 0.1
        out[k] = v
    return out


@pytest.mark.parametrize("case", list(FAMILIES))
def test_tp_forward_and_input_gradient_equal_replicated_and_jaxs(case, mesh8, jmesh8):
    import importlib

    family, ctor, head = FAMILIES[case]
    jmod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu.models.{family}")
    pmod = importlib.import_module(
        f"image_recognition_adversarial_example_attack_tpu_torch.models.{family}")
    kw = {} if case == "resnet" else {"num_classes": 8}
    rng = np.random.RandomState(4)
    x = rng.rand(8, 32, 32, 3)
    y = rng.randint(0, 8, 8)
    model = getattr(pmod, ctor)(**kw)
    variables = seeded_variables(model, family, _perturb)
    with jax.enable_x64():
        module = getattr(jmod, ctor)(dtype=jnp.float64, **kw)
        placed = jax_mesh.shard_model_variables(variables, jmesh8, tensor_parallel=True)

        def jax_logits(v, xx):
            _, st = module.apply(v, jax_normalize(xx, IMAGENET_MEAN, IMAGENET_STD),
                                 capture_intermediates=lambda mdl, _: mdl.name == head)
            return st["intermediates"][head]["__call__"][0]

        def ce(v, xx):
            lg = jax_logits(v, xx)
            return (-jnp.take_along_axis(jax.nn.log_softmax(lg), jnp.asarray(y)[:, None],
                                         1).sum(), lg)

        xj = jax.device_put(jnp.asarray(x), NamedSharding(jmesh8, JP("data")))
        if case in ("vit", "resnet"):
            (_, want), want_g = jax.jit(jax.value_and_grad(ce, argnums=1, has_aux=True))(
                placed, xj)
            want_g = np.asarray(want_g)
        else:  # JAX's TestTPAllFamilies: the forward
            want, want_g = jax.jit(jax_logits)(placed, xj), None
        want = np.asarray(want)
    model.load_state_dict(convert.from_jax_variables(variables, family), strict=True)
    model.requires_grad_(False).eval()
    tp = tensor_parallel_model(model, mesh8, family)
    assert min(shard_fractions(tp, model).values()) <= 0.5

    def logits_and_grad(m):
        xt = torch.from_numpy(x).requires_grad_(True)
        lg = m(port_normalize(xt, IMAGENET_MEAN, IMAGENET_STD).permute(0, 3, 1, 2))
        loss = -torch.log_softmax(lg, -1).gather(-1, torch.from_numpy(y)[:, None]).sum()
        (g,) = torch.autograd.grad(loss, xt)
        return lg.detach().numpy(), g.numpy()

    got, got_g = logits_and_grad(tp)
    rep, rep_g = logits_and_grad(model)
    np.testing.assert_allclose(got, rep, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g, rep_g, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.abs(rep_g).max() > 1e-4
    if want_g is not None:
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=TOL)


def test_tp_refuses_an_int8_model(mesh8):
    model = zoo.random_init_(zoo.build_model("resnet_tiny", int8=True))
    with pytest.raises(ValueError, match="int8"):
        tensor_parallel_model(model, mesh8, "resnet")


# ---------------------------------------------------------------------------
# the data axis: PGD, UAP and the eval cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny64():
    """resnet_tiny in float64 in both packages (uncast logits), a batch of
    16 at 32x32 and its clean labels."""
    variables = seeded_variables(port_models.resnet_tiny(num_classes=10), "resnet",
                                 port_perturb, seed=0)
    module = jax_resnet.resnet_tiny(dtype=jnp.float64, num_classes=10)
    model = port_resnet("resnet_tiny", variables, np.float64, num_classes=10)
    fns = uncast_fns(module, variables, model)
    x = np.random.RandomState(0).rand(16, 32, 32, 3)
    with torch.no_grad():
        y = torch.argmax(fns["port"][0](torch.from_numpy(x)), -1).numpy()
    return fns, x, y


def _fed_start(monkeypatch, start: np.ndarray):
    """pgd's start drawn as JAX drew it: a shard takes its rows."""
    def draw(shape, eps, generator, device):
        lo = getattr(generator, "lo", 0)
        return torch.from_numpy(start[lo:lo + shape[0]])
    monkeypatch.setattr(pgd, "draw_start", draw)


def test_sharded_pgd_equals_one_device_and_jaxs(tiny64, mesh8, jmesh8, monkeypatch):
    fns, x, y = tiny64
    xs = NamedSharding(jmesh8, JP("data"))
    with jax.enable_x64():
        key = jax.random.PRNGKey(7)
        start = np.asarray(jax.random.uniform(key, x.shape, jnp.float64, -EPS, EPS))

        def attack(xx, yy, k):
            return jax_pgd(fns["jax"][0], xx, yy, eps=EPS, alpha=ALPHA, steps=4, key=k)

        want = np.asarray(jax.jit(attack, in_shardings=(xs, xs, None), out_shardings=xs)(
            jax.device_put(jnp.asarray(x), xs), jax.device_put(jnp.asarray(y), xs), key))
    lf = fns["port"][0]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    # the port's own draws: sharded equals one device, bit for bit
    one = pgd_linf_attack(lf, xt, yt, eps=EPS, alpha=ALPHA, steps=4,
                          generator=generator_from_seed(7))
    got = dp.sharded_pgd_linf_attack(lf, shard_batch(x, mesh8), dp.shard_labels(y, mesh8),
                                     eps=EPS, alpha=ALPHA, steps=4,
                                     generator=generator_from_seed(7))
    assert torch.equal(got.gather(), one)
    assert len(got.shards) == 8 and torch.equal(got.shards[0], got.shards[1])
    # JAX's draws
    _fed_start(monkeypatch, start)
    fed = dp.sharded_pgd_linf_attack(lf, shard_batch(x, mesh8), dp.shard_labels(y, mesh8),
                                     eps=EPS, alpha=ALPHA, steps=4,
                                     generator=generator_from_seed(7))
    np.testing.assert_allclose(fed.gather().numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("batch_size", [None, 6])
def test_sharded_uap_equals_one_device_and_jaxs(batch_size, tiny64, mesh8, jmesh8):
    fns, x, y = tiny64
    lf = fns["port"][0]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    one = uap_attack(lf, xt, yt, eps=EPS, alpha=ALPHA, epochs=3, batch_size=batch_size,
                     generator=generator_from_seed(5))
    got = uap_attack(lf, shard_batch(x, mesh8), dp.shard_labels(y, mesh8), eps=EPS,
                     alpha=ALPHA, epochs=3, batch_size=batch_size,
                     generator=generator_from_seed(5))
    np.testing.assert_allclose(got.delta.numpy(), one.delta.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.loss_per_epoch.numpy(), one.loss_per_epoch.numpy(), rtol=0,
                               atol=1e-12)
    if batch_size is not None:
        return  # JAX's shuffles are other draws
    xs = NamedSharding(jmesh8, JP("data"))
    with jax.enable_x64():
        def train(xx, yy, k):
            res = jax_uap(fns["jax"][0], xx, yy, eps=EPS, alpha=ALPHA, epochs=3, key=k)
            return res.delta, res.loss_per_epoch

        delta, loss = jax.jit(train, in_shardings=(xs, xs, None))(
            jax.device_put(jnp.asarray(x), xs), jax.device_put(jnp.asarray(y), xs),
            jax.random.PRNGKey(5))
    np.testing.assert_allclose(got.delta.numpy(), np.asarray(delta), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.loss_per_epoch.numpy(), np.asarray(loss), rtol=0, atol=TOL)


@pytest.mark.parametrize("attack", ["fgsm", "pgd"])
def test_sharded_eval_cell_counters_equal_one_device_and_jaxs(attack, tiny64, mesh8, jmesh8):
    from image_recognition_adversarial_example_attack_tpu.eval.defense_eval import (
        DefenseEvalConfig as JaxConfig, evaluate_defenses_batch as jax_cell)

    fns, x, y = tiny64
    lf, ff = fns["port"]
    cfg = DefenseEvalConfig(attack_name=attack, eps=EPS, alpha=ALPHA, steps=2, cw_steps=2)
    one = evaluate_defenses_batch(lf, ff, torch.from_numpy(x), torch.from_numpy(y), 1.0, cfg,
                                  generator_from_seed(3))
    out = dp.evaluate_defenses_sharded(lf, ff, shard_batch(x, mesh8), dp.shard_labels(y, mesh8),
                                       1.0, cfg, generator_from_seed(3))
    for k in (*STAT_KEYS, "x_adv"):
        assert torch.equal(out[k].gather(), one[k]), k
    got = dp.sharded_counts(out)
    assert got == aggregate_stats(one)
    assert dp.sharded_counts(out, n_valid=13)["count"] == 13
    if attack != "fgsm":
        return
    xs = NamedSharding(jmesh8, JP("data"))
    jcfg = JaxConfig(attack_name="fgsm", eps=EPS, alpha=ALPHA, steps=2, cw_steps=2)
    with jax.enable_x64():
        def cell(xx, yy, thr, k):
            o = jax_cell(fns["jax"][0], fns["jax"][1], xx, yy, thr, jcfg, k)
            return {k2: jnp.sum(v) for k2, v in o.items() if k2 != "x_adv"}

        want = jax.jit(cell, in_shardings=(xs, xs, None, None))(
            jax.device_put(jnp.asarray(x), xs), jax.device_put(jnp.asarray(y), xs), 1.0,
            jax.random.PRNGKey(3))
    assert {k: got[k] for k in STAT_KEYS} == {k: int(want[k]) for k in STAT_KEYS}


# every other attack of the grid and the random defenses: a shard draws its
# rows of the unsharded run's draws (core.rng.batch_draw), whatever the
# draw's batch axis
FAST_BUDGETS = dict(steps=2, cw_steps=2, square_steps=4, deepfool_steps=2, est_samples=2,
                    bandits_steps=2, hsja_steps=1, hsja_probes=2, stadv_steps=2,
                    boundary_steps=2, simba_steps=4, jsma_steps=2, spatial_candidates=2)


@pytest.mark.parametrize("attack", [a for a in ATTACK_CHOICES if a not in ("fgsm", "pgd")])
def test_sharded_eval_cell_of_every_grid_attack_equals_one_device(attack, tiny64, mesh8):
    fns, x, y = tiny64
    lf, ff = fns["port"]
    cfg = DefenseEvalConfig(attack_name=attack, eps=EPS, alpha=ALPHA, **FAST_BUDGETS)
    one = evaluate_defenses_batch(lf, ff, torch.from_numpy(x), torch.from_numpy(y), 1.0, cfg,
                                  generator_from_seed(3))
    out = dp.evaluate_defenses_sharded(lf, ff, shard_batch(x, mesh8), dp.shard_labels(y, mesh8),
                                       1.0, cfg, generator_from_seed(3))
    for k in (*STAT_KEYS, "x_adv"):
        assert torch.equal(out[k].gather(), one[k]), k


@pytest.mark.parametrize("defense", ["randomization", "tv", "smoothing"])
def test_random_defenses_on_shards_draw_the_one_device_numbers(defense):
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.randomization import (
        resize_pad_transform)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.smoothing import (
        draw_noise)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.tv import tv_transform

    x = torch.from_numpy(np.random.RandomState(2).rand(8, 16, 16, 3))
    transform = {"randomization": resize_pad_transform(), "tv": tv_transform(steps=2),
                 "smoothing": lambda g, xx: draw_noise((3, *xx.shape), g, CPU)}[defense]
    rows = [(0, 3), (3, 8)]
    parts = [transform(g, x[lo:hi])
             for g, (lo, hi) in zip(shard_generators(generator_from_seed(5), rows, 8), rows)]
    want = transform(generator_from_seed(5), x)
    assert torch.equal(torch.cat(parts, dim=1 if defense == "smoothing" else 0), want)


def test_a_draw_that_does_not_route_a_shard_generator_raises():
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.eot import (
        make_eot_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import seed_draw, uniform

    g = shard_generators(generator_from_seed(0), [(0, 2), (2, 4)], 4)[1]
    with pytest.raises(TypeError):
        torch.rand((2,), generator=g)
    with pytest.raises(TypeError, match="seed_draw"):
        seed_draw(g)
    with pytest.raises(TypeError, match="seed_draw"):
        make_eot_logits_fn(lambda xx: xx, g)
    with pytest.raises(ValueError, match="batch axis"):
        uniform((3,), g, CPU)


def test_mesh_placer_shards_each_chunk(mesh8, monkeypatch):
    x = np.random.RandomState(1).rand(8, 4, 4, 3).astype(np.float32)
    got = make_placer(mesh8, transfer_uint8=False)(x)
    assert torch.equal(got.gather(), torch.from_numpy(x)) and len(got.shards) == 8
    u8 = make_placer(mesh8, transfer_uint8=True)(x)
    want = make_placer(CPU, transfer_uint8=True)(x)
    assert torch.equal(u8.gather(), want)


# ---------------------------------------------------------------------------
# the grid CLI on a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("imgs"), n=6, size=32)


def _grid(argv, mesh_devices=None):
    from image_recognition_adversarial_example_attack_tpu_torch.cli.defense_experiments import (
        main)

    buf = io.StringIO()
    patch = (mock.patch("image_recognition_adversarial_example_attack_tpu_torch.eval.engine."
                        "visible_devices", lambda device: mesh_devices)
             if mesh_devices else mock.patch.dict({}))
    with patch, redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_grid_cli_on_a_mesh_prints_the_one_device_lines(streamed, image_dir, tmp_path):
    argv = ["--image_dir", str(image_dir), "--attacks", "fgsm", "pgd", "--eps_list", "0.03137",
            "--viz_samples", "2", *FAST, *(["--max_batch", "3"] if streamed else [])]
    one = _grid([*argv, "--output_dir", str(tmp_path / "one")])
    sharded = _grid([*argv, "--output_dir", str(tmp_path / "mesh")], [CPU] * 4)
    assert "Mesh: {'data': 4, 'model': 1}" in sharded and "Mesh:" not in one
    lines = summary_lines(sharded)
    assert len(lines) == 2 and lines == summary_lines(one)
    cells = json.loads((tmp_path / "mesh" / "results_partial.json").read_text())
    assert all(c["count"] == 6 for c in cells.values())
    if streamed:
        assert "fixed chunks of 4" in sharded  # --max_batch 3 rounded to the data axis


def test_grid_cli_refuses_adaptive_host_jpeg_on_a_mesh(image_dir, tmp_path):
    with pytest.raises(SystemExit, match="--adaptive with the host JPEG codec"):
        _grid(["--image_dir", str(image_dir), "--adaptive", "--use_jpeg", "--jpeg_mode", "host",
               "--output_dir", str(tmp_path), *FAST], [CPU] * 2)
