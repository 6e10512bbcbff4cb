"""Config dataclasses of the PyTorch port.

The port's own copy of ``r3d_tpu/config.py``: the same dataclasses with the
same field names and defaults, so that a config built for one package reads
the same in the other. ``CONFIGS`` holds the configs whose model the port
serves (``futr_fusion_bn``). Fields that only the JAX package reads (mesh,
device cache, compile knobs) are kept so that the field sets stay equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset protocol knobs."""

    dataset: str = "utkinects"
    data_root: str = "./datasets"
    mapping_file: str = "mapping_l2_changed.txt"
    features_dir: str = "features_img"
    depth_features_dir: Optional[str] = "features_depth"  # None => RGB-only
    gt_dir: str = "groundTruth"
    splits_dir: str = "splits"
    split: str = "1"
    train_split: str = "train_split.txt"
    val_split: str = "val_split.txt"
    gt_format: str = "csv"              # csv|plain
    features_transposed: bool = False
    l1_relabel: bool = False
    label_from_filename: bool = False
    query_mapping_file: Optional[str] = None
    sample_rate: int = 1
    train_obs_percs: Tuple[float, ...] = (0.4, 0.45, 0.2, 0.25, 0.3, 0.35, 0.5, 0.55, 0.6, 0.65)
    pred_perc: float = 0.5
    future_frames: Optional[int] = None
    # Sequences pad up to the smallest bucket that holds them; the serving
    # path microbatches per bucket.
    seq_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2000)
    depth_shape: Tuple[int, int] = (160, 120)
    normalize_depth: bool = False
    gaze_pad_len: Optional[int] = None
    gaze_dir: Optional[str] = None
    multi_sequence: bool = False
    depth_dir_rewrite: Tuple[Tuple[str, str], ...] = (
        ("camera_1_fps_15", "depth_1"),
        ("camera_2_fps_15", "depth_2"),
    )
    raw_frames: bool = False
    raw_frame_wh: Tuple[int, int] = (224, 168)
    # Storage dtype of the feature and depth streams of a request batch.
    feature_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    """FUTR + fuser architecture."""

    model: str = "futr_fusion_bn"
    hidden_dim: int = 128
    n_head: int = 8
    n_encoder_layers: int = 2
    n_decoder_layers: int = 1
    n_query: int = 8
    input_dim: int = 2048
    max_pos_len: int = 2000
    dropout: float = 0.1
    seg: bool = True
    anticipate: bool = True
    pos_emb: bool = True
    input_type: str = "i3d_transcript"  # i3d_transcript|gt
    # The reference bypasses its encoder: memory = src.
    use_encoder: bool = False
    seg_excludes_none: bool = False
    fuser_depth: int = 1
    fuser_heads: int = 8
    fuser_dropout: float = 0.1
    fuser_exchange_frac: float = 0.1    # BN variant: bottom 10 % of channels
    query_num: int = 49
    erank_weight: float = 0.0
    erank_target: Optional[float] = None
    log_erank: bool = True
    sow_attn: bool = False
    compute_dtype: str = "float32"
    # Dtype of only the two wide input projections (input and depth embed);
    # None follows compute_dtype.
    embed_dtype: Optional[str] = None
    use_pallas: bool = True
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    frozen_stats: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and loop."""

    loop: str = "proposed_depth"
    batch_size: int = 8
    val_batch_size: Optional[int] = None
    epochs: int = 60
    warmup_epochs: int = 10
    lr: float = 1e-3
    weight_decay: float = 5e-3
    seeds: Tuple[int, ...] = (1, 10, 13452)
    min_train_batch: int = 8
    sticky_eval: Optional[bool] = None
    init_ckpt: Optional[str] = None
    exclude_class_idx: Optional[int] = None
    weighted_ce: bool = False
    label_smoothing: bool = False
    save_dir: str = "./save_dir"
    log_every: int = 50
    warmup_loss_epochs: Tuple[int, int] = (30, 60)
    l3_pad_idx: Optional[int] = None
    l3_exclude_idx: Optional[int] = None
    max_segments: int = 32
    supcon_weight: float = 0.0
    supcon_samples: int = 512
    supcon_temperature: float = 0.07
    steps_per_dispatch: int = 1
    grad_accum: int = 1
    device_cache: bool = False
    tensorboard: bool = False
    rng_impl: Optional[str] = None
    opt_mu_dtype: Optional[str] = None


@dataclass(frozen=True)
class EvalConfig:
    """MoC protocol."""

    eval_p: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.5)
    eval_batch: int = 8
    obs_percs: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    pred_p: float = 0.5
    max_eval_len: Optional[int] = None
    ant_acc_mode: str = "weighted"
    exclude_class_idx: Optional[int] = None
    query_mod2: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (not read by the port yet)."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"
    ep: int = 1
    fsdp: bool = False


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    name: str = "utkinects"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


CONFIGS = {
    # UTKinect RGB+depth token fuser (main_utkinects.py): batches stored in
    # bf16, the two wide embeds in bf16, everything after them in fp32.
    "utkinects": Config(
        name="utkinects",
        data=DataConfig(dataset="utkinects", feature_dtype="bfloat16"),
        model=ModelConfig(model="futr_fusion_bn", embed_dtype="bfloat16"),
        train=TrainConfig(loop="proposed_depth", exclude_class_idx=47,
                          weighted_ce=True, device_cache=True),
        eval=EvalConfig(exclude_class_idx=16),
    ),
    # Synthetic smoke config: the same model, no data on disk.
    "synthetic": Config(
        name="synthetic",
        data=DataConfig(
            dataset="synthetic", gt_format="plain", seq_buckets=(64, 128),
            train_obs_percs=(0.2, 0.3, 0.5), depth_shape=(160, 120),
        ),
        model=ModelConfig(model="futr_fusion_bn", max_pos_len=256),
        train=TrainConfig(loop="proposed_depth", epochs=2, min_train_batch=0),
    ),
}


def get_config(name: str) -> Config:
    return CONFIGS[name]
