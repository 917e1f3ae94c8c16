"""The port's logical-axis sharding rules (``repro_torch.distributed.
sharding``) against the reference's (``repro.distributed.sharding``):
every case of ``tests/test_sharding.py``, and each parameter's logical axes
and spec equal to the reference's for every config.

Pure logic on the production meshes' shape tables (16 x 16 and 2 x 16 x
16), so no process group is made here; the DTensor path runs in
``test_torch_dryrun.py``'s subprocess."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core.tree import Stacked  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES, ShardingCtx, annotate, param_logical_axes, param_specs,
    split_heads, use_mesh)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402


class FakeMesh:
    """A mesh's shape table, as the reference's tests build one."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

# Parameters whose port spec differs from the reference's.  None: where
# DTensor cannot unflatten an uneven head split (llama3.2-3b's 24 heads on
# the 16-way axis, ...), ``split_heads`` gathers the activation and the
# weights keep the reference's spec.
EXCEPTIONS: dict = {}


def _ctx(shape):
    ctx = ShardingCtx.__new__(ShardingCtx)
    ctx.mesh = FakeMesh(shape)
    ctx.rules = dict(DEFAULT_RULES)
    return ctx


def _ref_ctx(shape):
    ctx = ref_sharding.ShardingCtx.__new__(ref_sharding.ShardingCtx)
    ctx.mesh = FakeMesh(shape)
    ctx.rules = dict(ref_sharding.DEFAULT_RULES)
    return ctx


@functools.lru_cache(maxsize=None)
def _port_model(cfg):
    dev = torch.device("meta")
    return encdec.EncDec(cfg, dev) if cfg.enc_dec else lm.LM(cfg, dev)


def test_annotate_noop_without_mesh():
    x = torch.ones((4, 4))
    assert annotate(x, "batch", None) is x
    assert split_heads(torch.ones((2, 3, 8)), 2, 4, "heads").shape == \
        (2, 3, 2, 4)


def test_resolve_drops_non_dividing():
    ctx = _ctx(MESHES["16x16"])
    assert ctx.resolve("heads", 3072) == "model"     # divisible
    assert ctx.resolve("heads", 24) is None          # 24 % 16 != 0 -> dropped
    assert ctx.resolve("vocab", 51865) is None       # whisper odd vocab
    assert ctx.resolve("batch", 256) == "data"       # no pod axis -> data only
    assert ctx.resolve("batch", 8) is None
    multi = _ctx(MESHES["2x16x16"])
    assert multi.resolve("batch", 256) == ("pod", "data")
    assert multi.resolve("batch", 2) == "pod"


@pytest.mark.parametrize("name", [(a, b) for a in (3072, 24, 51865, 256, 8)
                                  for b in ("heads", "vocab", "batch",
                                            "fsdp", "d_model")],
                         ids=str)
def test_resolve_matches_reference(name):
    dim, logical = name
    for shape in MESHES.values():
        assert _ctx(shape).resolve(logical, dim) == \
            _ref_ctx(shape).resolve(logical, dim)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    ctx = _ctx(MESHES["2x16x16"])
    assert ctx.placements((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert ctx.placements((None, None)) == (Replicate(),) * 3


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_param_specs_valid_for_production_mesh(name, mesh):
    """Every parameter gets a legal placement: no duplicate mesh axes,
    every sharded dim divisible, at most one Shard per mesh axis."""
    cfg = get_config(name)
    ctx = _ctx(MESHES[mesh])
    model = _port_model(cfg)
    for pname, spec in param_specs(model, ctx, fsdp=cfg.fsdp).items():
        shape = dict(model.named_parameters())[pname].shape
        used = []
        for dim, entry in zip(shape, spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            total = 1
            for a in axes:
                assert a not in used, f"duplicate axis {a} in {pname}"
                used.append(a)
                total *= ctx.sizes[a]
            assert dim % total == 0, f"{pname}: {dim} % {total}"
        assert len(ctx.placements(spec)) == len(ctx.sizes)


@functools.lru_cache(maxsize=None)
def _ref_leaves(cfg):
    """{path: (shape, stacked)} of the reference's parameter tree, shapes
    from ``jax.eval_shape``."""
    init = ref_encdec.init_params if cfg.enc_dec else ref_lm.init_params
    shapes = jax.eval_shape(lambda: init(jax.random.key(0), cfg))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        out[tuple(ref_sharding._path_names(path))] = tuple(leaf.shape)
    return out


@functools.lru_cache(maxsize=None)
def _port_leaves(cfg):
    """{reference path: (dotted name of one layer's tensor, its shape,
    stacked)} of the port's parameters, laid out by ``lm.param_tree``."""
    model = _port_model(cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        first = node[0] if isinstance(node, Stacked) else node
        out[path] = (names[id(first)], tuple(first.shape),
                     isinstance(node, Stacked))
    walk(lm.param_tree(model), ())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_specs_match_reference(name, mesh):
    """Each parameter's logical axes and spec are the reference's, the
    reference's leading layer (or repeat) dim removed, for every config."""
    cfg, rcfg = get_config(name), ref_config(name)
    ctx, rctx = _ctx(MESHES[mesh]), _ref_ctx(MESHES[mesh])
    ref, port = _ref_leaves(rcfg), _port_leaves(cfg)
    assert set(ref) == set(port)
    specs = param_specs(_port_model(cfg), ctx, fsdp=cfg.fsdp)
    for path, rshape in ref.items():
        pname, shape, stacked = port[path]
        raxes = ref_sharding.param_logical_axes(path, rshape, fsdp=rcfg.fsdp)
        rspec = tuple(rctx.spec(raxes, rshape))
        if stacked:
            # the layer dim is never sharded (the reference's rank-based
            # rule names it "experts" for a shared expert's stacked leaf,
            # which no mesh axis divides)
            assert rspec[0] is None, path
            raxes, rspec = raxes[1:], rspec[1:]
        axes = param_logical_axes(pname, shape, fsdp=cfg.fsdp)
        if pname in EXCEPTIONS:
            continue
        assert axes == raxes, (pname, axes, raxes)
        assert specs[pname] == rspec, (pname, specs[pname], rspec)


def test_expert_weights_ep_sharded():
    axes = param_logical_axes("blocks.0.moe.experts.w_gate",
                              (384, 7168, 2048), fsdp=True)
    assert axes[0] == "experts"              # EP on the expert dim
    assert "heads" not in axes and "ff" not in axes
    # the optimizer's stacked state takes the same rule, its layer dim first
    stacked = param_logical_axes(("m", "blocks", "moe", "experts", "w_gate"),
                                 (61, 384, 7168, 2048), fsdp=True)
    assert stacked == (None,) + axes
    assert stacked == ref_sharding.param_logical_axes(
        ("m", "blocks", "moe", "experts", "w_gate"), (61, 384, 7168, 2048),
        fsdp=True)


def test_single_device_mesh_runs_model():
    """Model code under use_mesh on one device still runs (annotations are
    no-ops on plain tensors) and gives the same hidden states."""
    cfg = get_config("llama3.2-3b").reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    want, _ = lm.forward(params, cfg, lm.embed_tokens(params, cfg, tokens),
                         q_chunk=8)
    with use_mesh(make_local_mesh(1, 1, device="cpu")) as ctx:
        assert ctx.sizes == {"data": 1, "model": 1}
        x = lm.embed_tokens(params, cfg, tokens)
        hid, _ = lm.forward(params, cfg, x, q_chunk=8)
    assert hid.shape == (2, 8, cfg.d_model)
    assert torch.equal(hid, want)
