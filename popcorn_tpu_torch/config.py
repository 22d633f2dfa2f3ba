"""Configuration, paths and the per-region data registry.

Replaces the reference's three coexisting config mechanisms
(configargparse CLI, hard-coded cluster-path probing in
utils/constants.py:16-60, and the fvcore CfgNode of
model/DDA_model/utils/experiment_manager.py) with one dataclass-based
config whose data root comes from the ``POPCORN_DATA`` environment
variable or an explicit argument — no hard-coded scratch paths.

Registry tables mirror the factual content of the reference's
utils/constants.py:66-179 (census/boundary file registry, test levels,
skip indices, DDA model definition) so that a reference user finds the
same regions, levels and defaults.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Core geometry constants (reference: utils/constants.py:12-13)
# ---------------------------------------------------------------------------

INFERENCE_PATCH_SIZE = 2048
OVERLAP = 128

SEASONS = ("spring", "summer", "autumn", "winter")
SEASON_TO_IDX = {s: i for i, s in enumerate(SEASONS)}
IDX_TO_SEASON = {i: s for i, s in enumerate(SEASONS)}

# ---------------------------------------------------------------------------
# Census / boundary registry (reference: utils/constants.py:66-143)
# ---------------------------------------------------------------------------

DATALOCATIONS: Dict[str, Dict[str, Dict[str, str]]] = {
    "pricp2": {
        "fine": {"boundary": "boundaries4.tif", "census": "census4.csv"},
        "fineBLOCKCE": {
            "boundary": "boundaries_BLOCKCE20.tif",
            "census": "census_BLOCKCE20.csv",
        },
        "fineCOUNTYFP": {
            "boundary": "boundaries_COUNTYFP20.tif",
            "census": "census_COUNTYFP20.csv",
        },
        "fineTRACTCE": {
            "boundary": "boundaries_TRACTCE20.tif",
            "census": "census_TRACTCE20.csv",
        },
        "coarseTRACTCE": {
            "boundary": "boundaries_coarseTRACTCE20.tif",
            "census": "census_coarseTRACTCE20.csv",
        },
        "coarse": {
            "boundary": "boundaries_TRACTCE20.tif",
            "census": "census_TRACTCE20.csv",
        },
    },
    "rwa": {
        "fine100": {
            "boundary": "boundaries_kigali100.tif",
            "census": "census_kigali100.csv",
        },
        "coarse": {"boundary": "boundaries_coarse.tif", "census": "census_coarse.csv"},
    },
    "uga": {
        "coarse": {"boundary": "boundaries.tif", "census": "census.csv"},
        "fine": {"boundary": "boundaries.tif", "census": "census.csv"},
    },
    "che": {
        "coarse4": {
            "boundary": "boundaries_coarse4.tif",
            "census": "census_coarse4.csv",
        },
        "coarse3": {
            "boundary": "boundaries_coarse3.tif",
            "census": "census_coarse3.csv",
        },
        "coarse1": {
            "boundary": "boundaries_coarse1.tif",
            "census": "census_coarse1.csv",
        },
        "finezurich": {
            "boundary": "boundaries_finezurich.tif",
            "census": "census_finezurich.csv",
        },
        "finezurich2": {
            "boundary": "boundaries_finezurich2.tif",
            "census": "census_finezurich2.csv",
        },
        "fine": {"boundary": "boundaries_fine.tif", "census": "census_fine.csv"},
        "coarse": {
            "boundary": "boundaries_coarse4.tif",
            "census": "census_coarse4.csv",
        },
    },
}

# In-training test levels (reference: utils/constants.py:145-150)
TESTLEVELS: Dict[str, List[str]] = {
    "pricp2": ["fine", "fineTRACTCE"],
    "rwa": ["fine100", "coarse"],
    "uga": ["coarse"],
    "che": ["finezurich2", "coarse4"],
}

# Final-eval test levels (reference: utils/constants.py:152-157)
TESTLEVELS_EVAL: Dict[str, List[str]] = {
    "pricp2": ["fine", "fineTRACTCE"],
    "rwa": ["fine100", "coarse"],
    "uga": ["coarse"],
    "che": ["fine", "finezurich2", "coarse4"],
}

# Census indices to skip during training (reference: utils/constants.py:161-166)
SKIP_INDICES: Dict[str, List[int]] = {
    "pricp2": [],
    "rwa": [],
    "uga": [1323],
    "che": [],
}

# Regions whose descending-orbit S1 has gaps that must be filled from the
# ascending orbit (reference: run_train.py:414, run_eval.py:227)
NEED_ASCENDING_FILL = ("uga",)

# Region-specific occupancy-head bias initialisations used by the paper runs
# (reference: README.md:182-197)
REGION_BIASINIT: Dict[str, float] = {
    "che": 0.2267,
    "rwa": 0.9407,
    "uga": 0.9407,
    "pricp2": 0.4119,
}

# ---------------------------------------------------------------------------
# DDA dual-stream UNet definition (reference: utils/constants.py:169-179)
# ---------------------------------------------------------------------------

STAGE1_FEATS = 8
STAGE2_FEATS = 16
DDA_TOPOLOGY = (STAGE1_FEATS, STAGE2_FEATS)
SENTINEL1_BANDS = ("VV", "VH")
SENTINEL2_BANDS = ("B02", "B03", "B04", "B08")
DDA_CHECKPOINT_NAME = (
    f"fusionda_newAug{STAGE1_FEATS}_{STAGE2_FEATS}_checkpoint30_lossweight0.5.pt"
)

# BatchNorm epsilon used when folding frozen torch BatchNorm2d running stats
# into per-channel scale/shift constants (torch default eps).
BN_EPS = 1e-5


def _candidate_dda_checkpoints() -> List[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    return [
        os.environ.get("POPCORN_DDA_CHECKPOINT", ""),
        os.path.join(here, "..", "weights", DDA_CHECKPOINT_NAME),
    ]


def find_dda_checkpoint() -> Optional[str]:
    """Locate the pretrained DDA dual-stream UNet torch checkpoint: the
    ``POPCORN_DDA_CHECKPOINT`` override, else ``weights/`` beside the
    package."""
    for cand in _candidate_dda_checkpoints():
        if cand and os.path.isfile(cand):
            return cand
    return None


# ---------------------------------------------------------------------------
# Data-root resolution
# ---------------------------------------------------------------------------


class DataPaths:
    """Resolves the on-disk PopMapData layout from a single data root.

    Layout (identical to the reference's PopMapData tree, README.md:118-156):
      <root>/PopMapData/processed/<region>/<boundary|census files>
      <root>/PopMapData/merged/EE/<region>/S1spring/<region>_S1spring.tif ...
      <root>/PopMapData/raw/EE/<region>/S1spring/*.tif  (unmerged tiles)
      <root>/PopMapData/raw/GoogleBuildings/<region>/...
    """

    def __init__(self, root: Optional[str] = None):
        root = root or os.environ.get("POPCORN_DATA")
        if root is None:
            raise ValueError(
                "No data root given: set POPCORN_DATA or pass data_root explicitly."
            )
        self.root = root
        base = os.path.join(root, "PopMapData")
        self.processed = os.path.join(base, "processed")
        self.covariates = os.path.join(base, "merged", "EE")
        self.raw_ee = os.path.join(base, "raw", "EE")
        self.gbuildings = os.path.join(base, "raw", "GoogleBuildings")

    def boundary_path(self, region: str, level: str) -> str:
        return os.path.join(
            self.processed, region, DATALOCATIONS[region][level]["boundary"]
        )

    def census_path(self, region: str, level: str) -> str:
        return os.path.join(
            self.processed, region, DATALOCATIONS[region][level]["census"]
        )

    def modality_path(self, region: str, modality: str, season: str, asc: bool = False) -> str:
        """Path of a merged seasonal mosaic, e.g. S1spring / S2Aspring / viirs."""
        if modality == "viirs":
            return os.path.join(self.covariates, region, "viirs", f"{region}_viirs.tif")
        prefix = {"S1": "S1", "S2": "S2A"}[modality]
        name = f"{prefix}{season}" + ("Asc" if asc else "")
        return os.path.join(self.covariates, region, name, f"{region}_{name}.tif")

    def raw_tile_dir(self, region: str, modality: str, season: str, asc: bool = False) -> str:
        prefix = {"S1": "S1", "S2": "S2A"}[modality]
        name = f"{prefix}{season}" + ("Asc" if asc else "")
        return os.path.join(self.raw_ee, region, name)

    def gbuildings_counts_path(self, region: str) -> str:
        """Per-pixel building-count raster (Google Open Buildings, or the
        SwissTLM3D footprints for che — reference PopulationDataset.py:277-286)."""
        if region == "che":
            base = self.gbuildings.replace("GoogleBuildings", "SwissBuildings")
            return os.path.join(base, "che_buildings_counts.tif")
        return os.path.join(self.gbuildings, region, f"Gbuildings_{region}_counts.tif")

    def gbuildings_segmentation_path(self, region: str) -> str:
        if region == "che":
            base = self.gbuildings.replace("GoogleBuildings", "SwissBuildings")
            return os.path.join(base, "che_buildings_segmentation.tif")
        return os.path.join(
            self.gbuildings, region, f"Gbuildings_{region}_segmentation.tif"
        )

    def mosaic_index_path(self, region: str, modality: str, season: str, asc: bool = False) -> str:
        """Our equivalent of the reference's on-the-fly GDAL VRT
        (data/PopulationDataset.py:195-219): a JSON mosaic index over the
        unmerged raw tiles, built once and reused."""
        prefix = {"S1": "S1", "S2": "S2A"}[modality]
        name = f"{prefix}{season}" + ("Asc" if asc else "")
        return os.path.join(self.raw_ee, region, f"{name}_mosaic.json")


# ---------------------------------------------------------------------------
# Run configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelConfig:
    """POPCORN model configuration (reference: model/get_model.py:34-61)."""

    s1: bool = True
    s2: bool = True
    nir: bool = True
    viirs: bool = False  # read+normalize+assemble VIIRS nightlights; the DDA
    # reorder ignores trailing channels, matching the reference's evident
    # semantics (PopulationDataset.py:267 resolves the file, utils.py:123-125
    # normalizes it, but calculate_input_channels never counts it)
    occupancy_model: bool = True
    pretrained: bool = True
    biasinit: float = 0.75
    sentinel_buildings: bool = True
    building_input: bool = False  # -binp: carry pre-rasterised building
    # counts through the pipeline (reference arguments/train.py:22)
    segmentation_input: bool = False  # -sinp: keep/derive the building
    # segmentation raster (reference utils/utils.py:153-159)
    feature_extractor: str = "DDA"
    compute_dtype: str = "float32"  # the kernels take float32 only
    quantize: Optional[str] = None  # int8 modes are not ported yet
    remat_unet: bool = False  # torch.utils.checkpoint the trainable UNet
    # blocks in training: their activations are recomputed in the backward

    @property
    def input_channels(self) -> int:
        # reference: model/get_model.py:23-32
        ch = 0
        if self.s1:
            ch += 2
        if self.nir:
            ch += 1
        if self.s2:
            ch += 3
        return ch


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (reference: arguments/train.py:8-61).

    The fields of the JAX package's TrainConfig, with its defaults. The
    multi-device and device-resident options are kept so that a config
    carries across, but the port does not run them yet: ``check()`` raises
    for them, naming the ROADMAP item that ports them."""

    target_regions: Tuple[str, ...] = ("rwa",)
    target_regions_train: Tuple[str, ...] = ("rwa",)
    train_level: Tuple[str, ...] = ("coarse",)
    weak_batch_size: int = 2
    weak_val_batch_size: int = 1
    num_epochs: int = 100
    learning_rate: float = 1e-4
    loss: Tuple[str, ...] = ("log_l1_loss",)
    lam: Tuple[float, ...] = (1.0,)
    lam_weak: float = 100.0
    scale_regularization: float = 0.01
    weight_decay: float = 0.0
    lr_step: int = 5
    lr_gamma: float = 0.75
    gradient_clip: float = 0.01
    seed: int = 1600
    limit1: int = 9_000_000  # pixels above which the encoder is frozen
    limit2: int = 9_000_000  # pixels above which the whole UNet is frozen
    limit3: int = 13_000_000  # pixels above which the sample is skipped
    max_weak_samples: Optional[int] = None
    max_weak_pix: int = 10_000_000
    max_pix_box: int = 12_000_000
    weak_validation: bool = False
    val_every_n_epochs: int = 2
    val_every_i_steps: int = 500_000  # mid-epoch validation (reference -vi)
    test_every_i_steps: int = 500_000  # mid-epoch target test (reference -testi)
    logstep_train: int = 25
    asc_aug: bool = False
    fourseasons: bool = True
    save_dir: str = "outputs"
    num_workers: int = 6
    save_model: str = "both"  # 'last' | 'best' | 'no' | 'both'; 'best'
    # tracks the weak-validation optimization loss
    skip_first: bool = False  # run epoch 0 but discard its updates
    max_samples: Optional[int] = None  # cap on weak samples drawn per epoch
    bucket_ladder: Tuple[int, ...] = (256, 512, 1024, 1536, 2048, 3072, 4096)
    data_parallel: int = 1  # > 1 not ported: ROADMAP Queue 1 item 16
    multihost: bool = False  # not ported: ROADMAP Queue 1 item 16
    val_in_memory: bool = False  # preload validation rasters into host RAM
    watch_every: int = 0  # >0: log per-layer grad norms + param histograms
    device_feed: str = "auto"  # "on" not ported: ROADMAP Queue 1 item 13
    spatial_train: bool = False  # not ported: ROADMAP Queue 1 item 17
    grad_accum: int = 1  # microbatches per optimizer update
    transport: str = "exact"  # "bf16" not ported: ROADMAP Queue 1 item 13
    feed_gate: str = "auto"  # "off" (keep the rotating feed) not ported:
    # ROADMAP Queue 1 item 13

    def check(self) -> None:
        """Raise for options whose feature the port does not run yet."""
        todo = [
            (self.data_parallel > 1, f"data_parallel={self.data_parallel}", 16),
            (self.multihost, "multihost", 16),
            (self.spatial_train, "spatial_train", 17),
            (self.device_feed == "on", "device_feed='on'", 13),
            (self.transport != "exact", f"transport={self.transport!r}", 13),
            (self.feed_gate == "off", "feed_gate='off'", 13),
        ]
        for bad, what, item in todo:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})"
                )


@dataclasses.dataclass
class EvalConfig:
    """Evaluation configuration (reference: arguments/eval.py:3-27)."""

    target_regions: Tuple[str, ...] = ("rwa",)
    train_level: Tuple[str, ...] = ("coarse",)
    checkpoints: Tuple[str, ...] = ()
    fourseasons: bool = False
    seed: int = 1610
    save_dir: str = "./results"
    num_workers: int = 8
    patch_batch: int = 1  # patches per forward during sliding-window eval
    in_memory: bool = False  # preload mosaics into host RAM
    patchsize: int = 2048  # reference inference_patch_size (constants.py:12)
    overlap: int = 128  # reference overlap (constants.py:13)

    def __post_init__(self):
        # a degenerate pair (patchsize <= 2*overlap) would zero out the
        # halo-validity mask for interior patches and silently stitch nothing
        if self.patchsize <= 2 * self.overlap:
            raise ValueError(
                f"--patchsize ({self.patchsize}) must exceed twice "
                f"--patch_overlap ({self.overlap}): the halo mask keeps only "
                f"the interior (patchsize - 2*overlap) pixels of each patch"
            )


def load_dataset_stats(path: Optional[str] = None) -> Dict[str, Dict[str, List[float]]]:
    """Load per-modality normalization statistics.

    Same JSON schema as the reference's data/config/dataset_stats.json
    (consumed at run_train.py:404-411).
    """
    if path is None:
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.join(here, "data", "config", "dataset_stats.json")
    with open(path, "r") as f:
        return json.load(f)
