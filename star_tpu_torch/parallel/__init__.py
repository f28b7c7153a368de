"""Data, tensor, context and sequence parallelism on torch.distributed
(counterpart of star_tpu/parallel/): NCCL between cards, gloo on the CPU."""

from .mesh import (AXIS_CONTEXT, AXIS_DATA, AXIS_TENSOR, P, Mesh,
                   data_sharding, make_mesh, replicated, single_device_mesh)
from .sharding import param_specs, shard_params, spec_for_path, TP_RULES
from .zero import shard_opt_state, opt_state_memory_bytes
from .ulysses import ulysses_attention
from .context_parallel import cp_causal_conv3d, cp_group_norm
from .distributed import init_distributed, make_hybrid_mesh
