"""Data, tensor, pipeline, sequence and expert parallelism over
``torch.distributed``, one process per device (PyTorch port of
``pose_estimation_amitai_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    shard_params,
)
from .pipeline import (  # noqa: F401
    PipelinedViT,
    make_pipeline_mesh,
    make_pipelined_train_step,
)
from .sequence import (  # noqa: F401
    make_seq_mesh,
    ring_attention,
)
from .expert import (  # noqa: F401
    MoEFeedForward,
    make_expert_mesh,
)
