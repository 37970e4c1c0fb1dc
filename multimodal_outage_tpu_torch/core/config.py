"""Typed configuration: the port's own copy of the JAX package's config
dataclasses (same fields, same defaults)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# Dataset normalization stats (reference utils.py:31-32).
DEFAULT_NTL_MEAN = 3.201447427712248
DEFAULT_NTL_STD = 10.389727592468262

# NASA Black Marble fill-value sentinel zeroed on load (reference utils.py:60).
NTL_FILL_SENTINEL = 6.5535e03


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data/synthetic"
    image_size: int = 128
    n_counties: int = 67
    channels: int = 1
    horizon: int = 7
    dataset_range: int = 30  # ± days around each hurricane
    mean: float = DEFAULT_NTL_MEAN
    std: float = DEFAULT_NTL_STD
    val_fraction: float = 0.3
    prefetch: int = 2
    pipeline: str = "auto"
    device_store_budget_mb: int = 4096
    # dtype of the model-input batches; the frame store and the targets
    # stay float32
    device_dtype: str = "bfloat16"
    shard_store: bool = False


@dataclass(frozen=True)
class GWNetConfig:
    """Graph WaveNet hyperparameters (reference models/graph_wavenet.py:101)."""

    residual_channels: int = 32
    dilation_channels: int = 32
    skip_channels: int = 256
    end_channels: int = 512
    kernel_size: int = 1
    blocks: int = 4
    layers: int = 2
    dropout: float = 0.3
    order: int = 2
    gcn_bool: bool = True
    addaptadj: bool = True
    randomadj: bool = True
    node_embed_dim: int = 10
    adjtype: str = "identity"
    use_pallas: bool = False
    reference_view_quirk: bool = False


@dataclass(frozen=True)
class DCRNNConfig:
    max_diffusion_step: int = 2
    num_rnn_layers: int = 2
    rnn_units: int = 64
    filter_type: str = "dual_random_walk"
    teacher_forcing: float = 0.0
    tf_decay_steps: int = 0


@dataclass(frozen=True)
class ModelConfig:
    st_gnn: str = "gwnet"
    input_channels: int = 1
    output_channels: int = 1
    base_channels: int = 4
    depth: int = 4
    feature_vector_size: int = 256
    time_embed_size: int = 64
    compression_factor: int = 4
    encoder_dropout: float = 0.3
    train_date2vec: bool = False
    d2v_bundle: Optional[str] = None
    gwnet: GWNetConfig = field(default_factory=GWNetConfig)
    dcrnn: DCRNNConfig = field(default_factory=DCRNNConfig)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    remat_scope: str = "all"
    pool: str = "reduce_window"
    bn_single_pass: bool = True

    def __post_init__(self):
        if self.remat_scope not in ("all", "stem", "conv"):
            raise ValueError(
                f"remat_scope must be 'all', 'stem', or 'conv', got "
                f"{self.remat_scope!r}"
            )
        if self.pool not in ("reduce_window", "pairwise", "pallas"):
            raise ValueError(
                f"pool must be 'reduce_window', 'pairwise', or 'pallas', "
                f"got {self.pool!r}"
            )

    @property
    def st_gnn_in_dim(self) -> int:
        return self.feature_vector_size + self.time_embed_size


@dataclass(frozen=True)
class TrainConfig:
    """The JAX TrainConfig's fields and defaults (JAX core/config.py:171-212).
    train/loop.py:fit raises on the knob the port does not run yet
    (grad_accum ≠ 1); donate_buffers and xla_vmem_limit_kib are XLA settings that the port
    keeps for the config record and does not read."""

    epochs: int = 5  # reference lit.py:211
    batch_size: int = 16  # reference lit.py:213
    lr: float = 1e-3  # reference lit.py:60
    cosine_t_max: int = 10  # reference lit.py:61
    early_stop_patience: int = 10  # reference lit.py:181
    seed: int = 42  # reference lit.py:14
    log_every: int = 6  # reference lit.py:204
    checkpoint_dir: str = "logs"
    job_id: str = "test"
    keep_top_k: int = 1  # reference lit.py:194 save_top_k=1
    donate_buffers: bool = True
    grad_accum: int = 1
    xla_vmem_limit_kib: int = 49152
    resume: bool = False
    tensorboard: bool = False
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    profile_steps: int = 5

    def __post_init__(self):
        if self.grad_accum < 0:
            raise ValueError(
                f"grad_accum must be >= 1, or 0 for auto; got {self.grad_accum}"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes (JAX core/config.py:215-222); the port runs one
    device, so only the single-device settings are accepted by fit."""

    data: int = -1
    model: int = 1
    time: int = 1


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    adjacency_csv: Optional[str] = None  # None ⇒ packaged Florida asset

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
