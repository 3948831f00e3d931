"""Multi-device serving and training on torch.distributed, under the JAX
package's names: the mesh, the head- and sequence-sharded attention and
decode (mesh.py), the tensor- and sequence-parallel serving engine
(tp_engine.py), ring attention, plain, 8-bit and trainable
(ring_attention.py), Ulysses (ulysses.py), the DP x TP, context-parallel
and optimizer-driven training steps (train.py) and the GPipe pipeline
(pipeline.py). Every rank runs the same calls on its own shards; see
mesh.py. Expert parallelism is models.make_ep_moe, and the MoE branch of
the DP x TP steps."""

from flashattention_kernel_project_tpu_torch.parallel import (  # noqa: F401
    mesh,
    pipeline,
    tp_engine,
    train,
    ulysses,
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
from flashattention_kernel_project_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pp_train_step,
    pp_loss_fn,
    pp_param_specs,
)
from flashattention_kernel_project_tpu_torch.parallel.ring_attention import (  # noqa: F401
    merge_normalized,
    ring_attention,
    ring_attention_kv_quant,
    ring_attention_trainable,
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
from flashattention_kernel_project_tpu_torch.parallel.train import (  # noqa: F401
    make_cp_train_step,
    make_optax_train_step,
    make_train_step,
)
from flashattention_kernel_project_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
)
