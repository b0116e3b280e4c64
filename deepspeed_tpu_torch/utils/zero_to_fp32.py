"""Consolidate a training checkpoint into one f32 state dict.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py`` (the reference's
``deepspeed/utils/zero_to_fp32.py``, the script that turns a ZeRO checkpoint
into a plain ``pytorch_model.bin``). On one card the tag already holds whole
f32 masters, so consolidation reads the tag's ``params`` shard (validated
against its manifest first) and writes it out flat.

CLI: ``python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir>
<output_file> [--tag TAG]`` (``checkpoint_dir`` is the engine's save dir,
whose ``latest`` is followed, or one tag's directory). Output format by
extension: ``.pt``/``.bin`` a torch state dict, anything else numpy ``.npz``.
"""

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..runtime.checkpoint_engine.checkpoint_engine import (TorchCheckpointEngine,
                                                           resolve_tag_dir,
                                                           validate_manifest)
from .logging import logger


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, torch.Tensor]:
    """Reference ``get_fp32_state_dict_from_zero_checkpoint``: parameter name
    -> f32 CPU tensor."""
    path = resolve_tag_dir(checkpoint_dir, tag)
    state_path = os.path.join(path, "state")
    if not os.path.isdir(state_path):
        raise FileNotFoundError(f"no engine state at {state_path}")
    validate_manifest(path)
    params = TorchCheckpointEngine().load_subtree(state_path, "params")
    return {k: v.to(torch.float32) for k, v in params.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None
                                               ) -> Dict[str, torch.Tensor]:
    """Reference ``convert_zero_checkpoint_to_fp32_state_dict``: write the f32
    state dict to ``output_file`` and return it."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    n_params = sum(v.numel() for v in sd.values())
    if output_file.endswith(".pt") or output_file.endswith(".bin"):
        torch.save(sd, output_file)
    else:
        np.savez(output_file if output_file.endswith(".npz") else output_file + ".npz",
                 **{k: v.numpy() for k, v in sd.items()})
    logger.info(f"consolidated {len(sd)} tensors / {n_params:,} fp32 params -> {output_file}")
    return sd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint into one fp32 state dict")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file", help=".pt/.bin (torch) or .npz (numpy)")
    p.add_argument("--tag", default=None, help="checkpoint tag (default: latest)")
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
