"""Tensor parallelism of the port (``aldi_tpu_torch/parallel/tensor.py``,
``TPU.MESH_MODEL``) on the data x model grid (``parallel/mesh.py``), on the
CPU: gloo ranks spawned through ``tests/torch_port_dist.py``.

- The rules: ``mesh.tp_spec`` and ``mesh.fsdp_spec`` on every family's
  tiny model choose the leaves and the slices that the JAX package's
  ``tp_spec``/``fsdp_spec`` choose on the counterpart flax leaves. Each
  JAX leaf is filled with 1, 2, ... and, per model rank, zeroed outside
  JAX's shard; the port's converter (``engine/checkpoint_convert.py``)
  carries the values, so the nonzero elements of each port tensor are
  JAX's shard in the port's layout (the ViT's head-major qkv [C, 3, nh,
  hd] becomes rows (3, nh, hd) of [3C, C]), and the port's
  ``local_part`` must pick exactly those. ``tensor.shard_module`` and
  ``fsdp.shard_module`` must split exactly the chosen parameters.
- The step: ``tests/test_tensor_parallel.py``'s tiny burn-in config
  (``_tiny``: ResNet-26, canvas 64, batch 8, labeled_strong) with
  SOLVER.BASE_LR 0.01 and no warmup (at the JAX test's warmup factor the
  first step moves the parameters by about 1e-6, which no parameter
  tolerance tells from a wrong gradient), at M = 2 on W = 2 and on
  D = 2 x M = 2 (W = 4), against the port's world-1 step and against the
  JAX package's step on its 4x2 mesh (``make_mesh(8, model_parallel=2)``,
  ``shard_state``): one JAX compile for the file.

Tolerances, as the JAX test holds its TP step against DP: losses 1e-5
relative, parameters 1e-4 absolute (the student moves by 1.5e-2).
Measured: the TP steps against world 1, losses 1.2e-7 relative and
parameters 3.0e-8 at W = 2 and W = 4; against the JAX mesh, losses 1.2e-7
and 3.8e-8, parameters 1.5e-8. The model peers' replicated parameters are
bitwise equal. Each planted fault of ``tests/torch_port_grid.py`` exceeds
the loss limit: the row-parallel bias added on both model ranks by 2.0e-2
relative, the denominators over W instead of D by 0.5, the model group's
all-reduce over the four ranks by 0.37.
"""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.parallel import mesh as jax_mesh
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.parallel import fsdp, mesh, tensor
from tests import torch_port_dist as dist_run
from tests import torch_port_draws as draws_from
from tests import torch_port_grid as grid
from tests.test_torch_port_convnext import convnext_cfg
from tests.test_torch_port_train_step import jax_tree, torch_tree
from tests.torch_port_common import (detr_cfg, max_err, seeded_variables,
                                     tiny_cfg, tiny_vit, vitdet_head_config,
                                     yolo_cfg)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank:
    the same sums in the same order but for the split ones."""
    with torch_threads(1):
        yield


def set_keys(cfg, **overrides):
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def burnin_cfg(get_cfg, **overrides):
    """``tests/test_tensor_parallel.py`` ``_tiny(daod=False)``
    (``__graft_entry__._tiny_cfg`` at canvas 64, depth 26, and its top-k
    and sampler sizes) in either package, at SOLVER.BASE_LR 0.01 without
    warmup, float32."""
    cfg = get_cfg()
    set_keys(cfg, **{
        "MODEL.RESNETS.DEPTH": 26,
        "MODEL.ANCHOR_GENERATOR.SIZES": [[32], [64], [128], [256], [512]],
        "MODEL.ROI_HEADS.NUM_CLASSES": 8, "MODEL.ROI_BOX_HEAD.NUM_FC": 2,
        "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 7,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 32, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 16,
        "MODEL.RPN.PRE_NMS_TOPK_TEST": 32, "MODEL.RPN.POST_NMS_TOPK_TEST": 16,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 8,
        "TEST.DETECTIONS_PER_IMAGE": 5, "TPU.CANVAS": (64, 64),
        "TPU.MAX_GT": 16, "SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.01,
        "DATASETS.BATCH_CONTENTS": ("labeled_strong",), "EMA.ENABLED": True,
        "TPU.COMPUTE_DTYPE": "float32"})
    return set_keys(cfg, **overrides)


def test_burnin_cfg_is_the_jax_tests():
    """The JAX side of ``burnin_cfg`` is ``_tiny(daod=False)`` but for the
    learning rate and the warmup."""
    want = ge._tiny_cfg(canvas=(64, 64), depth=26, daod=False)
    set_keys(want, **{
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 32, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 16,
        "MODEL.RPN.PRE_NMS_TOPK_TEST": 32, "MODEL.RPN.POST_NMS_TOPK_TEST": 16,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 8,
        "TEST.DETECTIONS_PER_IMAGE": 5, "SOLVER.WARMUP_ITERS": 0,
        "SOLVER.BASE_LR": 0.01, "TPU.COMPUTE_DTYPE": "float32"})
    assert burnin_cfg(jax_get_cfg).dump() == want.dump()


# --------------------------------------------------------------- the rules
ALIGNED = {"DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
           "DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED": True,
           # two widths: JAX's name rule hits linear1, which then has no
           # row-parallel partner
           "DOMAIN_ADAPT.ALIGN.INS_DA_HIDDEN_DIMS": [64, 32]}


def family_cfg(family, get_cfg):
    if family == "rcnn":
        return burnin_cfg(get_cfg, **ALIGNED)
    if family == "vit":
        return vitdet_head_config(tiny_cfg(get_cfg))
    if family == "convnext":
        return convnext_cfg(get_cfg)
    if family == "detr":
        return detr_cfg(get_cfg)
    return yolo_cfg(get_cfg)


@pytest.fixture(scope="module")
def families():
    """``family -> (the JAX params' flat shapes, the port detector)``,
    the ViT with 4 heads (``tiny_vit``)."""
    out = {}

    def get(family):
        if family not in out:
            with tiny_vit(num_heads=4):
                jdet = jax_build_detector(family_cfg(family, jax_get_cfg))
                shapes = jax.eval_shape(jdet.init_variables,
                                        jax.random.PRNGKey(0))
                det = build_detector(family_cfg(family, port_get_cfg),
                                     device="cpu")
            flat = flatten_dict(dict(shapes["params"]))
            out[family] = {k: tuple(v.shape) for k, v in flat.items()}, det
        return out[family]

    return get


def _key(*names):
    return tuple(jax.tree_util.DictKey(n) for n in names)


class _Leaf:
    def __init__(self, shape):
        self.shape, self.ndim = shape, len(shape)
        self.size = int(np.prod(shape))


def _port(tree):
    """A flat {path: array} params tree in the port's names and layouts."""
    nested = {}
    for path, v in tree.items():
        node = nested
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return jax_variables_to_state_dict({"params": nested})


def _heads(module, name):
    """The head count of the attention that holds parameter ``name``."""
    if ".attn." not in name:
        return None
    return module.get_submodule(name.split(".attn.")[0] + ".attn").num_heads


def _held(positions, numel):
    """A mask over ``numel`` elements, True at ``positions``."""
    mask = torch.zeros(numel, dtype=torch.bool)
    mask[positions.reshape(-1)] = True
    return mask


@pytest.mark.parametrize("m,d", [(2, 2), (4, 4)])
@pytest.mark.parametrize("family", ["rcnn", "vit", "convnext", "detr",
                                    "yolo"])
def test_specs_choose_jax_leaves_and_slices(families, family, m, d):
    """Per model rank, the elements of each port parameter that the port's
    ``tp_spec``/``local_part`` give the rank are those of JAX's
    ``tp_spec`` shard; FSDP (composed with the model axis) chooses the
    same leaves; ``shard_module`` splits exactly the chosen ones."""
    shapes, det = families(family)
    values = {k: np.arange(1, int(np.prod(s)) + 1, dtype=np.float32)
              .reshape(s) for k, s in shapes.items()}
    full = _port(values)
    specs = {k: jax_mesh.tp_spec(_key(*k), _Leaf(s), m)
             for k, s in shapes.items()}
    n_tp = 0
    for r in range(m):
        masked = {}
        for k, v in values.items():
            mask = np.ones_like(v)
            if specs[k] != P():
                axis = list(specs[k]).index("model")
                mask = np.zeros_like(v)
                idx = [slice(None)] * v.ndim
                n = v.shape[axis] // m
                idx[axis] = slice(r * n, (r + 1) * n)
                mask[tuple(idx)] = 1
            masked[k] = v * mask
        got = _port(masked)
        for name, t in full.items():
            kind = mesh.tp_spec(name, t.shape, m, _heads(det.module, name))
            pos = torch.arange(t.numel()).view(t.shape)
            if kind is not None:
                pos = mesh.local_part(pos, mesh.Shard(
                    "model", kind, tuple(t.shape)), r, m)
                n_tp += r == 0
            assert torch.equal(got[name].reshape(-1) != 0,
                               _held(pos, t.numel())), (family, name, kind)
    # FSDP: which JAX leaves each port tensor holds (DETR packs three)
    index = {k: i + 1 for i, k in enumerate(shapes)}
    tags = _port({k: np.full(s, index[k], np.float32)
                  for k, s in shapes.items()})
    by_index = {i: k for k, i in index.items()}
    chosen = set()
    for name, t in tags.items():
        leaves = {by_index[int(i)] for i in torch.unique(t).tolist()}
        want = {specs[k] == P() and jax_mesh.fsdp_spec(_Leaf(shapes[k]), d)
                != P() for k in leaves}
        assert len(want) == 1, (family, name)
        kind = mesh.tp_spec(name, t.shape, m, _heads(det.module, name))
        got = kind is None and mesh.fsdp_spec(t.shape, d)
        assert got == want.pop(), (family, name)
        if got:
            chosen.add(name)
    print(f"{family}, M={m}, D={d}: {n_tp} parameters split on the model "
          f"axis, {len(chosen)} on the data axis")
    if family in ("rcnn", "vit", "convnext", "detr"):
        assert n_tp > 0
    # the modules: split exactly the chosen parameters (a grid of this
    # process alone: the parts are made without a collective)
    with tiny_vit(num_heads=4):
        module = build_detector(family_cfg(family, port_get_cfg),
                                device="cpu").module
    try:
        mesh._process["grid"] = mesh.Grid(d, m, 0, 0)
        split = set(tensor.shard_module(module, m))
        sharded = set(fsdp.shard_module(module, d))
    finally:
        mesh.drop_grid()
    want_tp = {n.rsplit(".", 1)[0] for n, t in full.items()
               if mesh.tp_spec(n, t.shape, m, _heads(det.module, n))}
    assert split == want_tp
    assert sharded == chosen


def test_tp_rule_cases():
    """``tests/test_tensor_parallel.py::test_tp_spec_rules``'s cases on the
    port's names and layouts (Linear weight [out, in])."""
    assert mesh.tp_spec("roi_heads.box_head.fc1.weight", (64, 128), 2) \
        == "column"
    assert mesh.tp_spec("roi_heads.box_head.fc1.bias", (64,), 2) == "column"
    assert mesh.tp_spec("backbone.net.blocks.0.mlp.fc1.weight", (128, 32),
                        4) == "column"
    assert mesh.tp_spec("backbone.net.blocks.0.mlp.fc2.weight", (32, 128),
                        4) == "row"
    assert mesh.tp_spec("backbone.net.blocks.0.mlp.fc2.bias", (32,), 4) \
        is None
    assert mesh.tp_spec("backbone.bottom_up.stages.0.0.pwconv1.weight",
                        (64, 16), 2) == "column"
    assert mesh.tp_spec("backbone.net.blocks.0.attn.qkv.weight", (192, 64),
                        4, heads=8) == "heads"
    assert mesh.tp_spec("backbone.net.blocks.0.attn.qkv.bias", (192,), 4,
                        heads=8) == "heads"
    assert mesh.tp_spec("backbone.net.blocks.0.attn.proj.weight", (64, 64),
                        4, heads=8) == "row"
    assert mesh.tp_spec("backbone.net.blocks.0.attn.proj.bias", (64,), 4,
                        heads=8) is None
    assert mesh.tp_spec("backbone.net.blocks.0.attn.qkv.weight", (192, 64),
                        4, heads=6) is None
    assert mesh.tp_spec("roi_heads.box_head.fc1.weight", (63, 128), 2) \
        is None
    assert mesh.tp_spec("proposal_generator.rpn_head.conv.weight",
                        (16, 16, 3, 3), 2) is None
    assert mesh.tp_spec("head.notfc1.weight", (16, 16), 2) is None
    assert mesh.fsdp_spec((1 << 9, 1 << 9), 8)
    assert mesh.fsdp_spec((512, 64, 3, 3), 8)
    assert not mesh.fsdp_spec((256,), 8)
    assert not mesh.fsdp_spec((3, 5, 7, 1023), 8)  # big, no dim of 8


# ---------------------------------------------------------------- the step
def burnin_setup():
    """(JAX cfg, port cfg, weights as JAX variables, the batch of 8 as
    numpy, the step's key)."""
    jcfg, tcfg = burnin_cfg(jax_get_cfg), burnin_cfg(port_get_cfg)
    variables = seeded_variables(jax_build_detector(jcfg), seed=0)
    batch = jax.tree_util.tree_map(
        np.asarray, ge._fake_batch(8, (64, 64), 16, False))
    return jcfg, tcfg, variables, batch, jax.random.PRNGKey(1)


def jax_mesh_step(jcfg, variables, batch, rng, model_parallel=2,
                  fsdp_=False):
    """The JAX package's jitted step on the 8 devices' mesh of
    ``model_parallel`` model ranks: (metrics, the student's parameters as
    a port state dict)."""
    jdet = jax_build_detector(jcfg)
    state, tx = jax_create_train_state(jcfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params,
                          frozen=jax_tree(dict(variables["frozen"])),
                          opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    grid_ = jax_mesh.make_mesh(8, model_parallel=model_parallel)
    state = jax_mesh.shard_state(state, grid_, fsdp=fsdp_)
    step = jax_make_train_step(jcfg, jdet, tx)
    state, m = step(state, jax_mesh.shard_batch(jax_tree(batch), grid_), rng)
    sd = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, state.params)})
    return {k: float(v) for k, v in m.items()}, sd


def port_draws(tcfg, rng, n):
    """The labeled_strong stream's draws of the JAX step's key ``rng``
    (``train_step_draws``; one unlabeled image, whose entries go)."""
    det = build_detector(tcfg, device="cpu")
    d = draws_from.train_step_draws(rng, tcfg, n, 1,
                                    det.anchors_cat.shape[0])
    return {k: d[k] for k in ("strong", "aug_labeled")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's burn-in step at world 1 and on the grid: W = 2 (M = 2)
    clean and with two faults planted, W = 4 (2 x 2) clean and with the
    model group's reductions over the default group."""
    _, tcfg, variables, batch, rng = burnin_setup()
    weights = jax_variables_to_state_dict(variables)
    batches, draws = [torch_tree(batch)], [port_draws(tcfg, rng, 8)]
    cfg = dist_run.portable(tcfg)
    world1 = grid.steps(cfg, weights, batches, draws)
    tmp = tmp_path_factory.mktemp("tp")
    faults = {2: (None, "bias per model rank", "denominators over W"),
              4: (None, "tp over the default group")}
    ranks = {w: dist_run.run_ranks(grid.grid_steps, w, tmp, 2, cfg, weights,
                                   batches, draws, faults[w])
             for w in (2, 4)}
    return world1, ranks, faults, weights


@pytest.fixture(scope="module")
def jax_4x2():
    jcfg, _, variables, batch, rng = burnin_setup()
    return jax_mesh_step(jcfg, variables, batch, rng)


def summed(ranks, run, m=2):
    """The data ranks' metric shares summed (one model rank of each
    data rank)."""
    outs = [r[run] for r in ranks[::m]]
    return {k: sum(o["metrics"][0][k] for o in outs)
            for k in outs[0]["metrics"][0]}


def loss_err(got, want):
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-3)
               for k in want)


def param_err(got, want):
    return max(max_err(got[k].numpy(), w.numpy()) for k, w in want.items()
               if w.is_floating_point())


@pytest.mark.parametrize("w", [2, 4])
def test_tp_step_equals_world1(runs, w):
    """At M = 2 on W = 2 and W = 4: the losses (summed over the data ranks)
    and world 1's parameters gathered from the shards are world 1's step;
    the box head's fc1 is split on every rank; model peers hold bitwise
    equal replicated parameters."""
    world1, ranks, _, start = runs
    got = summed(ranks[w], 0)
    lerr = loss_err(got, world1["metrics"][0])
    perr = param_err(ranks[w][0][0]["student"], world1["student"])
    moved = param_err(world1["student"], start)
    print(f"W={w}: losses {lerr:.3g} relative (tol {LOSS_RTOL}), "
          f"parameters {perr:.3g} (tol {PARAM_ATOL}); the student moved "
          f"{moved:.3g}")
    assert lerr <= LOSS_RTOL and perr <= PARAM_ATOL
    assert moved >= 100 * PARAM_ATOL
    for r in ranks[w]:
        shards = r[0]["bytes"]["shards"]
        assert shards["roi_heads.box_head.fc1.weight"][0] == "model"
        assert shards["roi_heads.box_head.fc2.weight"][0] == "model"
    for a, b in zip(ranks[w][::2], ranks[w][1::2]):  # model peers
        ra, rb = a[0]["replicated"], b[0]["replicated"]
        assert ra.keys() == rb.keys()
        assert all(torch.equal(ra[k], rb[k]) for k in ra)


@pytest.mark.parametrize("w", [2, 4])
def test_tp_step_equals_the_jax_4x2_mesh(runs, jax_4x2, w):
    """The grid's step against the JAX package's step on its 4x2 mesh."""
    (j_m, j_s), (_, ranks, _, _) = jax_4x2, runs
    got = summed(ranks[w], 0)
    lerr = loss_err(got, j_m)
    perr = param_err(ranks[w][0][0]["student"], j_s)
    print(f"W={w} vs the JAX 4x2 mesh: losses {lerr:.3g} relative (tol "
          f"{LOSS_RTOL}), parameters {perr:.3g} (tol {PARAM_ATOL})")
    assert lerr <= LOSS_RTOL and perr <= PARAM_ATOL


@pytest.mark.parametrize("fault,w", [("bias per model rank", 2),
                                     ("denominators over W", 2),
                                     ("tp over the default group", 4)])
def test_planted_faults_exceed_the_tolerances(runs, fault, w):
    """Each planted fault (``tests/torch_port_grid.py``) takes the step
    past the loss or the parameter tolerance."""
    world1, ranks, faults, _ = runs
    run = faults[w].index(fault)
    lerr = loss_err(summed(ranks[w], run), world1["metrics"][0])
    perr = param_err(ranks[w][0][run]["student"], world1["student"])
    print(f"{fault} planted at W={w}: losses {lerr:.3g} relative, "
          f"parameters {perr:.3g}")
    assert lerr > LOSS_RTOL or perr > PARAM_ATOL


# ---------------------------------------------------------------- the grid
def grid_layout(rank, world, m):
    """This rank's indices on the grid of ``m`` model ranks and what the
    data and the model group's reductions give it."""
    import torch.distributed as dist

    g = mesh.make_grid(m)
    x = torch.tensor([float(rank)])
    y = x.clone()
    dist.all_reduce(y, group=mesh.model_group())
    return {"data": (mesh.data_rank(), mesh.data_world()),
            "model": (mesh.model_rank(), mesh.model_world()),
            "global_count": float(mesh.global_count(x)),
            "model_sum": float(y), "global_batch": mesh.global_batch(3),
            "grid": (g.data, g.model),
            "positions": mesh.shard_positions(8).tolist()}


def test_grid_layout_at_2x2(tmp_path):
    """Rank r of W = 4 at M = 2 has data index r // 2 and model index
    r % 2; counts sum over its data group, the model group sums adjacent
    ranks; model peers hold the same share of the batch."""
    out = dist_run.run_ranks(grid_layout, 4, tmp_path, 2)
    for r, o in enumerate(out):
        assert o["data"] == (r // 2, 2) and o["model"] == (r % 2, 2)
        assert o["grid"] == (2, 2) and o["global_batch"] == 6
        assert o["global_count"] == (r % 2) + (r % 2 + 2)
        assert o["model_sum"] == (r // 2) * 4 + 1
        assert o["positions"] == [4 * (r // 2) + i for i in range(4)]


def test_check_grid_raises():
    """W not divisible by TPU.MESH_MODEL raises JAX's error; so does a
    TPU.MESH_DATA other than W / M. Without a group the grid is world 1."""
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "TPU.MESH_MODEL=2"):
        mesh.check_grid(burnin_cfg(port_get_cfg, **{"TPU.MESH_MODEL": 2}))
    with pytest.raises(ValueError, match="TPU.MESH_DATA=2"):
        mesh.check_grid(burnin_cfg(port_get_cfg, **{"TPU.MESH_DATA": 2}))
    mesh.check_grid(burnin_cfg(port_get_cfg, **{"TPU.FSDP": True}))
    g = mesh.make_grid(1)
    try:
        assert (g.data, g.model, mesh.data_rank(), mesh.model_rank()) == (
            1, 1, 0, 0)
        x = torch.arange(3.0)
        assert mesh.global_count(x) is x and mesh.data_group() is None
    finally:
        mesh.drop_grid()
