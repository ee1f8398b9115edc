"""Configuration of the PyTorch port: a copy of ``dnascent_tpu/config.py``
(the port imports nothing of the JAX package), kept field for field so a
run of either package is configured alike.

The reference scatters its scientific constants between a global-config
singleton (reference: src/config.h:32-66) and hard-coded literals inside the
subprogram files (DBSCAN epsilon at src/forkSense.cpp:967, segment minLength at
src/forkSense.cpp:286, etc.).  Here every numeric parameter of every stage is
collected into typed, frozen dataclasses so that presets for other
pore/substrate chemistries can be added the way ``configure_DNA_R10`` intended.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class EventDetectionParams:
    """t-statistic change-point segmentation parameters.

    Mirrors the scrappie defaults (reference: src/scrappie/event_detection.h:19-25).
    """

    window_length1: int = 3
    window_length2: int = 6
    threshold1: float = 1.4
    threshold2: float = 9.0
    peak_height: float = 0.2


@dataclass(frozen=True)
class HMMTransitionParams:
    """HMM transition probabilities (reference: src/config.h:42)."""

    external_D2D: float = 0.3
    external_D2M: float = 0.7
    external_I2M: float = 0.999
    external_M2D: float = 0.0025
    internal_M2I: float = 0.001
    internal_I2I: float = 0.001


@dataclass(frozen=True)
class BandedAlignmentParams:
    """Adaptive banded alignment parameters (reference: src/config.h:41).

    ``lp_skip``/``lp_trim`` literals come from
    src/event_handling.cpp:179-183; QC thresholds from
    src/event_handling.cpp:433-441.
    """

    min_average_log_emission: float = -2.0
    max_gap_threshold: int = 5
    bandwidth: int = 100
    epsilon_skip: float = 1e-30       # lp_skip = ln(1e-30)
    p_trim: float = 0.01              # lp_trim = ln(0.01)
    min_cleaned_events: int = 1000    # event_handling.cpp:438


@dataclass(frozen=True)
class ScalingParams:
    """Signal-normalisation parameters.

    Quantile regression (reference: src/event_handling.cpp:451-541) and
    Theil-Sen refinement (src/event_handling.cpp:24-110).
    """

    n_quantiles: int = 10
    theilsen_max_points: int = 1000
    theilsen_trim: int = 50
    theilsen_min_length: int = 1000


@dataclass(frozen=True)
class DetectParams:
    """detect subprogram parameters (reference: src/detect.cpp:63-65, src/reads.h:11-12)."""

    min_mapping_quality: int = 20
    min_read_length: int = 1000
    raw_depth: int = 20               # RAWDEPTH: raw samples kept per ref position
    n_features: int = 5               # NFEATURES (legacy)
    hmm_window: int = 12              # llAcrossRead windowLength (detect.cpp:885)
    event_mean_min: float = 0.0       # signal guard (alignment.cpp:624)
    event_mean_max: float = 250.0
    call_threshold: float = 0.5       # probability > 0.5 counts as a call


@dataclass(frozen=True)
class AlignParams:
    """align subprogram defaults (reference: src/alignment.cpp:82-83)."""

    min_mapping_quality: int = 20
    min_read_length: int = 100


@dataclass(frozen=True)
class ForkSenseParams:
    """forkSense parameters, centralising constants scattered through
    src/forkSense.cpp (epsilon :967, minLength :286, stitch :220, maxGap :600,
    filterSize :1068, resolution :1464) and src/reads.h:653."""

    dbscan_epsilon: int = 500
    segment_min_length: int = 1000
    segment_stitch: int = 3000
    fork_max_gap: int = 5000
    stall_filter_size: int = 2000
    call_fraction_resolution: int = 2000
    call_fraction_min_attempts_divisor: int = 10   # attempts >= resolution/10
    min_read_positions: int = 2000                 # forkSense.cpp:1648
    min_density_floor: float = 0.1                 # forkSense.cpp:969-970
    stall_beta: float = 1.0                        # forkSense.cpp:1081
    stall_min_attempts: int = 50                   # forkSense.cpp:1111
    stall_min_lhs: float = 0.2                     # forkSense.cpp:1115
    kmeans_init_c1: float = 0.01                   # twoMeans_fs forkSense.cpp:1350
    kmeans_init_c2: float = 0.5
    kmeans_tol: float = 0.0001
    kmeans_max_iter: int = 100
    min_call_fraction_windows: int = 10            # forkSense.cpp:1775


@dataclass(frozen=True)
class SeeBreaksParams:
    """seeBreaks parameters (reference: src/seeBreaks.cpp:438-439,509,571-574)."""

    bootstrap_iterations: int = 5000
    rng_seed: int = 221005
    forksense_boundary: int = 2000
    end_tolerance_r10: int = 250
    end_tolerance_r9: int = 500
    end_tolerance_sweep: int = 250      # sweep endTol..endTol+250
    end_tolerance_step: int = 50
    ci_z: float = 1.96


@dataclass(frozen=True)
class TrainGMMParams:
    """trainGMM parameters (reference: src/trainGMM.cpp:458-523)."""

    max_events_per_kmer: int = 10000
    dbscan_epsilon: float = 0.5
    dbscan_min_points_fraction: float = 0.025
    min_raw_events: int = 200
    min_filtered_events: int = 50
    em_tolerance: float = 0.01
    em_max_iterations: int = 100
    default_pi: float = 0.5
    prior_stdv_multiplier: float = 2.0  # second component starts at 2x ONT stdv


@dataclass(frozen=True)
class SubstrateConfig:
    """Full preset for one pore/substrate chemistry.

    The DNA R10.4.1 preset mirrors ``Global_Config::configure_DNA_R10``
    (reference: src/config.h:44-63).
    """

    name: str = "DNA_R10.4.1"
    kmer_len: int = 9
    window_length_align: int = 50
    sample_rate_hz: int = 5000
    static_stdv: float = 0.14           # data_IO.cpp:173
    fn_unlabelled_model: str = "r10.4.1_400bps.nucleotide.9mer.model"
    fn_fit_unlabelled_model: str = "r10.4.1_unlabelled_gaussian.model"
    fn_fit_analogue_model: str = "r10.4.1_BrdU_gaussian.model"
    events: EventDetectionParams = field(default_factory=EventDetectionParams)
    hmm: HMMTransitionParams = field(default_factory=HMMTransitionParams)
    banded: BandedAlignmentParams = field(default_factory=BandedAlignmentParams)
    scaling: ScalingParams = field(default_factory=ScalingParams)
    detect: DetectParams = field(default_factory=DetectParams)
    align: AlignParams = field(default_factory=AlignParams)
    forksense: ForkSenseParams = field(default_factory=ForkSenseParams)
    seebreaks: SeeBreaksParams = field(default_factory=SeeBreaksParams)
    traingmm: TrainGMMParams = field(default_factory=TrainGMMParams)

    @property
    def n_kmers(self) -> int:
        return 4 ** self.kmer_len

    def replace(self, **kwargs) -> "SubstrateConfig":
        return dataclasses.replace(self, **kwargs)


DNA_R10 = SubstrateConfig()

#: registry of available presets; structured to admit other chemistries the
#: way the reference's Global_Config was (src/config.h comment block).
PRESETS = {"DNA_R10.4.1": DNA_R10, "dna_r10.4.1": DNA_R10}


def default_models_dir() -> str:
    """Directory searched for pore-model TSVs, analogous to the exe-relative
    ``pore_models/`` directory in the reference (data_IO.cpp:146-147)."""
    env = os.environ.get("DNASCENT_TPU_MODELS")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "pore_models")


def get_config(name: Optional[str] = None) -> SubstrateConfig:
    if name is None:
        return DNA_R10
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown substrate preset '{name}'; available: {sorted(PRESETS)}")
