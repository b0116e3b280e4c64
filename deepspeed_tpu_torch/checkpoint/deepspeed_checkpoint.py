"""Reference-format checkpoint importer (Megatron-DeepSpeed 3D training checkpoints).

Counterpart of ``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py`` (itself a
re-design of ``deepspeed/checkpoint/deepspeed_checkpoint.py``): merge the
``layer_*-model_*`` / ``mp_rank_*`` tensor-parallel shards into full f32
tensors (column, row or replicated per Megatron name), rebuild f32 weights
from ``zero_pp_rank_*`` optimizer shards (``utils/zero_to_fp32.py`` semantics
for reference files), and convert a Megatron GPT into this package's
:class:`~deepspeed_tpu_torch.models.causal_lm.CausalLM` ``state_dict``. Where
the JAX package returns numpy arrays and a flax tree, this returns CPU
tensors, torch ``(out, in)`` weights as Megatron stores them.

Files are read one at a time, so peak host memory is one shard plus the merged
result. Reference files carry pickled Python objects (Megatron's ``args``
namespace), so they are read with ``weights_only=False``, as the JAX package
reads them: import only checkpoints you trust.
"""

import os
import re
from typing import Any, Dict, List, Optional

import torch

from ..utils.logging import logger
from .constants import (ARGS_KEY, GROUP_PADDINGS, ITERATION_KEY, LAYER_FILE_PREFIX,
                        MODEL_FILE_PREFIX, OPTIMIZER_STATE_DICT, PARAM_SHAPES,
                        SINGLE_PARTITION_OF_FP32_GROUPS, ZERO_STAGE)
from .reshape import (Model3DDescriptor, _files, _with_prefix, get_model_3d_descriptor,
                      get_zero_files, reshape_3d)

# Megatron tensor-parallel merge policy (reference deepspeed_checkpoint.py:26-36):
# names matching these suffixes are replicated across tp ranks (take rank 0);
# listed weights concatenate on dim 1 (row-parallel); everything else on dim 0.
SEQUENTIAL_LAYERS = [
    "input_layernorm.weight", "input_layernorm.bias",
    "self_attention.dense.bias", "attention.dense.bias",
    "post_attention_layernorm.weight", "post_attention_layernorm.bias",
    "mlp.dense_4h_to_h.bias",
    "position_embeddings.weight",
    "final_layernorm.weight", "final_layernorm.bias",
]
LAYER_CONCAT_DIM = {"self_attention.dense.weight": 1, "attention.dense.weight": 1,
                    "mlp.dense_4h_to_h.weight": 1}


def _torch_load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32)


def merge_tp_shards(name: str, shards: List[torch.Tensor]) -> torch.Tensor:
    """Merge one parameter's tensor-parallel shards per the Megatron policy."""
    # the final-layernorm layer file stores bare "weight"/"bias" (the module's own
    # state dict): replicated, like the dotted norm names
    if name in ("weight", "bias") or any(name.endswith(s) for s in SEQUENTIAL_LAYERS):
        return shards[0]
    if len(shards) == 1:
        return shards[0]
    for suffix, dim in LAYER_CONCAT_DIM.items():
        if name.endswith(suffix):
            return torch.cat(shards, dim=dim)
    return torch.cat(shards, dim=0)


class DeepSpeedCheckpoint:
    """Inspect and import a reference-format 3D checkpoint directory.

    ``tp_degree``/``pp_degree``/``dp_degree`` request a target topology for
    rank-file queries (contraction only, as in the reference); merged tensors
    are always full.
    """

    def __init__(self, dir: str, tp_degree: Optional[int] = None,
                 pp_degree: Optional[int] = None, dp_degree: Optional[int] = None):
        if not os.path.isdir(dir):
            raise FileNotFoundError(f"{dir} is not a checkpoint folder")
        self.dir = dir
        self.file_list = _files(dir)
        self.zero_files = get_zero_files(dir)
        self.layer_files = _with_prefix(self.file_list, LAYER_FILE_PREFIX)
        self.mp_rank_files = _with_prefix(self.file_list, MODEL_FILE_PREFIX)
        self.src_3d = get_model_3d_descriptor(dir)
        self.tp_degree = tp_degree or self.src_3d.tp_degree
        self.pp_degree = pp_degree or max(self.src_3d.pp_degree, 1)
        self.dp_degree = dp_degree or self.src_3d.dp_degree
        self.original_world_size = self.src_3d.world_size()
        self.world_size = self.tp_degree * self.pp_degree * self.dp_degree
        self.layer_keys = self._layer_keys()
        self.layer_count = len(self.layer_keys)
        self._file_map = None
        if self.src_3d.pp_degree > 0:
            self._file_map = reshape_3d(
                Model3DDescriptor(max(self.src_3d.pp_degree, 1),
                                  self.src_3d.tp_degree, self.src_3d.dp_degree),
                Model3DDescriptor(self.pp_degree, self.tp_degree, self.dp_degree))
        self.global_state: Dict[str, Any] = {}

    # ------------------------------------------------------------------ census
    def _layer_keys(self) -> List[str]:
        # numeric sort: 'layer_100' after 'layer_99'
        return sorted({m.group(1) for f in self.layer_files
                       for m in [re.match(rf"{LAYER_FILE_PREFIX}(\d+)-",
                                          os.path.basename(f))] if m}, key=int)

    def layer_shards(self, layer_key: str) -> List[str]:
        return sorted(f for f in self.layer_files
                      if os.path.basename(f).startswith(f"{LAYER_FILE_PREFIX}{layer_key}-"))

    def get_files_for_rank(self, pp_index: int, tp_index: int,
                           dp_index: int = 0) -> List[str]:
        """ZeRO optimizer files the given new-topology rank must merge
        (reference ``ZeROCheckpoint.get_files_for_rank``)."""
        if self._file_map is None:
            raise ValueError(f"{self.dir} has no pipeline layout (no layer files)")
        idxs = self._file_map[dp_index][(pp_index, tp_index)]
        return [self.zero_files[i] for i in idxs]

    # ------------------------------------------------------------------ global state
    def _build_global_state(self):
        if self.global_state or not self.mp_rank_files:
            return
        sd = _torch_load(self.mp_rank_files[0])
        self.global_state[ITERATION_KEY] = sd.get(ITERATION_KEY, 0)
        self.global_state[ARGS_KEY] = sd.get(ARGS_KEY, None)

    def get_iteration(self) -> int:
        self._build_global_state()
        return self.global_state.get(ITERATION_KEY, 0)

    def get_args(self):
        self._build_global_state()
        return self.global_state.get(ARGS_KEY)

    # ------------------------------------------------------------------ tensor merge
    def merged_layer_state(self, layer_key: str) -> Dict[str, torch.Tensor]:
        """One sequential layer's full tensors: its tp shard files, merged."""
        shards = [_torch_load(f) for f in self.layer_shards(layer_key)]
        if not shards:
            raise FileNotFoundError(f"{self.dir} has no files for layer {layer_key!r}")
        return {name: merge_tp_shards(name, [_f32(s[name]) for s in shards])
                for name in shards[0]}

    def merged_state_dict(self) -> Dict[str, torch.Tensor]:
        """All layers, keys prefixed ``<layer_key>.<param>`` (Megatron sequential
        numbering); for checkpoints without layer files, the merged ``mp_rank_*``
        module state instead."""
        if self.layer_keys:
            return {f"{lk}.{name}": v for lk in self.layer_keys
                    for name, v in self.merged_layer_state(lk).items()}
        if not self.mp_rank_files:
            raise FileNotFoundError(f"{self.dir} has no layer_* or mp_rank_* model files")
        flat = []
        for f in self.mp_rank_files:
            sd = _torch_load(f)
            flat.append(_flatten_module(sd.get("module", sd)))
        return {name: merge_tp_shards(name, [f[name] for f in flat]) for name in flat[0]}

    # ------------------------------------------------------------------ zero -> fp32
    def reconstruct_fp32_state_dict(self) -> Dict[str, torch.Tensor]:
        """Full f32 weights from ``zero_pp_rank_*`` optimizer shards (reference
        ``utils/zero_to_fp32.py`` for stage 1/2 files): concatenate each param
        group's per-dp flat partitions, trim the padding, split by the
        ``param_shapes`` of the matching ``mp_rank_*`` model file."""
        if not self.zero_files:
            raise FileNotFoundError(f"{self.dir} has no zero_pp_rank_* files")
        if not self.mp_rank_files:
            raise FileNotFoundError(f"{self.dir} has no mp_rank_* model file for "
                                    "param_shapes")
        param_shapes = _torch_load(self.mp_rank_files[0])[PARAM_SHAPES]
        if isinstance(param_shapes, dict):
            param_shapes = [param_shapes]
        opt_sds = [_torch_load(f)[OPTIMIZER_STATE_DICT] for f in self.zero_files]
        stage = opt_sds[0].get(ZERO_STAGE, 1)
        # the reference pads only the LAST dp rank's partition (stage_1_and_2.py:
        # 333-339 records 0 for the others), so the trailing pad of the
        # concatenated group is read from the last shard
        paddings = opt_sds[-1].get(GROUP_PADDINGS, [0] * len(param_shapes))
        out: Dict[str, torch.Tensor] = {}
        for gi, group_shapes in enumerate(param_shapes):
            flat = torch.cat([_f32(sd[SINGLE_PARTITION_OF_FP32_GROUPS][gi]).reshape(-1)
                              for sd in opt_sds])
            if paddings and gi < len(paddings) and paddings[gi] > 0:
                flat = flat[:-paddings[gi]]
            offset = 0
            for name, shape in group_shapes.items():
                n = 1
                for s in shape:
                    n *= int(s)
                if offset + n > flat.numel():
                    raise ValueError(f"group {gi} underflow at {name} (stage {stage}): "
                                     f"needs {offset + n} elements, has {flat.numel()}")
                out[name] = flat[offset:offset + n].reshape(tuple(shape)).clone()
                offset += n
            if offset != flat.numel():
                logger.warning(f"group {gi}: {flat.numel() - offset} trailing elements "
                               "unclaimed (alignment padding)")
        return out


def _flatten_module(sd: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted names of every tensor in a nested module dict (other leaves are
    skipped)."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flatten_module(v, prefix + str(k) + "."))
        elif isinstance(v, torch.Tensor):
            out[prefix + str(k)] = _f32(v)
    return out


# ---------------------------------------------------------------- Megatron -> CausalLM
def split_megatron_qkv(qkv: torch.Tensor, n_head: int):
    """Split a Megatron fused ``query_key_value`` weight or bias into q, k, v.

    Megatron interleaves per attention head: rows ordered [head, (q|k|v),
    head_dim] (reference ``megatron/model/transformer.py``; the containers undo
    this in ``module_inject/containers/megatron_gpt.py``)."""
    three_h = qkv.shape[0]
    if three_h % (3 * n_head):
        raise ValueError(f"fused qkv of {tuple(qkv.shape)} does not split over "
                         f"{n_head} heads")
    hn = three_h // (3 * n_head)
    parts = qkv.reshape(n_head, 3, hn, *qkv.shape[1:])
    return tuple(parts[:, i].reshape(n_head * hn, *qkv.shape[1:]).contiguous()
                 for i in range(3))


def to_causal_lm_params(ckpt: DeepSpeedCheckpoint, n_head: int,
                        n_layer: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A merged Megatron GPT checkpoint as a :class:`CausalLM` ``state_dict``
    (``wte``, ``wpe``, ``layers.{i}.q_proj.weight``, ..., ``ln_f.weight``), with
    the fused qkv de-interleaved; weights stay ``(out, in)``.

    Layer keys follow Megatron's sequential numbering: the embedding layer holds
    ``word_embeddings.weight`` / ``position_embeddings.weight``, transformer
    layers hold ``input_layernorm``/``self_attention``/``mlp`` blocks, the final
    layer holds the closing layernorm."""
    merged = ckpt.merged_state_dict()
    sd: Dict[str, torch.Tensor] = {}
    layer_ids = sorted({k.split(".")[0] for k in merged},
                       key=lambda s: int(s) if s.isdigit() else 10**9)
    n_blocks = 0
    for lid in layer_ids:
        names = {k[len(lid) + 1:]: v for k, v in merged.items() if k.startswith(lid + ".")}
        if "word_embeddings.weight" in names:
            sd["wte"] = names["word_embeddings.weight"]
            if "position_embeddings.weight" in names:
                sd["wpe"] = names["position_embeddings.weight"]
            continue
        if "input_layernorm.weight" in names:       # transformer block
            pre = f"layers.{n_blocks}"

            def pick(*options):
                return next((names[o] for o in options if o in names), None)

            qkv_w = pick("self_attention.query_key_value.weight",
                         "attention.query_key_value.weight")
            for proj, w in zip(("q_proj", "k_proj", "v_proj"),
                               split_megatron_qkv(qkv_w, n_head)):
                sd[f"{pre}.{proj}.weight"] = w
            qkv_b = pick("self_attention.query_key_value.bias",
                         "attention.query_key_value.bias")
            if qkv_b is not None:
                for proj, b in zip(("q_proj", "k_proj", "v_proj"),
                                   split_megatron_qkv(qkv_b, n_head)):
                    sd[f"{pre}.{proj}.bias"] = b
            sd[f"{pre}.o_proj.weight"] = pick("self_attention.dense.weight",
                                              "attention.dense.weight")
            sd[f"{pre}.ln_attn.weight"] = names["input_layernorm.weight"]
            sd[f"{pre}.ln_attn.bias"] = names["input_layernorm.bias"]
            sd[f"{pre}.ln_mlp.weight"] = names["post_attention_layernorm.weight"]
            sd[f"{pre}.ln_mlp.bias"] = names["post_attention_layernorm.bias"]
            sd[f"{pre}.fc_in.weight"] = names["mlp.dense_h_to_4h.weight"]
            sd[f"{pre}.fc_out.weight"] = names["mlp.dense_4h_to_h.weight"]
            for mega, ours in (("self_attention.dense.bias", "o_proj"),
                               ("attention.dense.bias", "o_proj"),
                               ("mlp.dense_h_to_4h.bias", "fc_in"),
                               ("mlp.dense_4h_to_h.bias", "fc_out")):
                if mega in names:
                    sd[f"{pre}.{ours}.bias"] = names[mega]
            n_blocks += 1
            continue
        if "weight" in names and names["weight"].ndim == 1:   # final layernorm
            sd["ln_f.weight"] = names["weight"]
            sd["ln_f.bias"] = names["bias"]
    if n_layer is not None and n_blocks != n_layer:
        raise ValueError(f"checkpoint has {n_blocks} transformer layers, expected {n_layer}")
    return sd
