"""Serving over a device mesh on torch.distributed: the mesh, the
head- and sequence-sharded attention and decode (mesh.py), and the
tensor- and sequence-parallel serving engine (tp_engine.py), under the JAX
package's names. Every rank runs the same calls on its own shards; see
mesh.py. Ring attention, Ulysses, the TP and CP training steps and the
pipeline (JAX's ring_attention.py, ulysses.py, train.py, pipeline.py) are
not ported yet (ROADMAP A.9)."""

from flashattention_kernel_project_tpu_torch.parallel import (  # noqa: F401
    mesh,
    tp_engine,
)
from flashattention_kernel_project_tpu_torch.parallel.mesh import (  # noqa: F401
    axis_group,
    axis_index,
    axis_size,
    head_sharded_attention,
    head_sharded_decode,
    head_sharded_decode_quant,
    make_mesh,
    seq_sharded_decode,
    shard_params,
)
from flashattention_kernel_project_tpu_torch.parallel.tp_engine import (  # noqa: F401
    cache_specs,
    init_sp_cache,
    init_tp_cache,
    init_tp_paged_cache,
    local_config,
    make_sp_decode_step,
    make_tp_engine,
    make_tp_paged_decode,
)
