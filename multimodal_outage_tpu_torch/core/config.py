"""Typed configuration: the port's own copy of the JAX package's config
dataclasses (same fields, same defaults), minus the train/mesh configs
that later slices bring."""

from __future__ import annotations

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
