"""Configuration of the port's extraction path.

The fields of ``sift3d.core.config.SiftConfig`` that the ported slice
reads, with the same names and defaults, plus :func:`from_numpy_state`,
which carries the JAX package's state into the port: the system has no
learned weights, so its "parameters" are the config fields and the static
host tables derived from them. The reference's other fields (matching,
BRIEF descriptors, XLA capacities, TPU precision knobs) have no effect
here and are accepted from another implementation only at their defaults.

Reference provenance of each default (paths relative to the reference
source tree, 3dsift_cleanup-softVote_App_Weight_SoftMax):

- blurs_per_octave=3, blurs_extra=3    src_common/MultiScale.cpp:50-52
- blur_precision=0.01                  src_common/MultiScale.cpp:42
- sigma_base=1.6, sigma_init=0.5       src_common/MultiScale.cpp:288-291
- ori_hist_blur_sigma=0.5              src_common/MultiScale.cpp:37
- ori_peak_threshold=0.8               src_common/MultiScale.cpp:2889
- ori_2nd_peak_threshold=0.5           src_common/MultiScale.cpp:40
- max_orientations=30 (effective 11)   src_common/MultiScale.cpp:1823-1824,2862
- eig_threshold=140                    featExtract/featExtract.cpp:297
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    # ---- scale-space pyramid ----
    blurs_per_octave: int = 3
    blurs_extra: int = 3
    blur_precision: float = 0.01
    sigma_base: float = 1.6
    sigma_init: float = 0.5

    # ---- feature geometry ----
    eig_threshold: float = 140.0

    # ---- orientation assignment ----
    ori_hist_blur_sigma: float = 0.5
    ori_peak_threshold: float = 0.8
    ori_2nd_peak_threshold: float = 0.5
    max_orientations: int = 11  # loop caps at FEATURE_3D_DIM (MultiScale.cpp:2862)
    # The reference bounds the TOTAL emitted copies at 11
    # (iOrientationsReturned < fioImg.z, MultiScale.cpp:2981) but neither
    # primaries examined (<= 11, MultiScale.cpp:2862) nor secondaries per
    # primary: k2 = 11 makes the per-primary envelope exact under the total
    # cap. k1 = 6 is a capacity approximation that changes results only
    # when > 6 strict-peak primaries reach 0.8 * max in one histogram.
    max_primary_orientations: int = 6
    max_secondary_orientations: int = 11

    @property
    def blurs_total(self) -> int:
        return self.blurs_per_octave + self.blurs_extra

    @property
    def sigma_factor(self) -> float:
        return float(2.0 ** (1.0 / self.blurs_per_octave))

    def level_sigmas(self) -> list:
        """Blur sigma of each pyramid level within an octave.

        ``sigmas[j] = sigma_base * sigma_factor**j`` for j in [0, blurs_total).
        Matches pfBlurSigmas in MultiScale.cpp:318-527.
        """
        return [self.sigma_base * self.sigma_factor**j for j in range(self.blurs_total)]

    def incremental_sigmas(self) -> list:
        """Extra blur applied between consecutive levels.

        sigma_extra[j] = sigmas[j-1] * sqrt(factor^2 - 1), the amount needed
        to raise level j-1 to level j (MultiScale.cpp:369).
        """
        f2 = self.sigma_factor * self.sigma_factor
        return [s * math.sqrt(f2 - 1.0) for s in self.level_sigmas()[:-1]]


DEFAULT_CONFIG = SiftConfig()


def initial_blur_sigma(cfg: SiftConfig) -> float:
    """Blur that raises the input image (sigma_init) to sigma_base
    (MultiScale.cpp:288-298)."""
    return math.sqrt(max(cfg.sigma_base**2 - cfg.sigma_init**2, 0.0))


def _blur_sigma(cfg: SiftConfig, name: str) -> float:
    if name == "initial":
        return initial_blur_sigma(cfg)
    if name == "ori_hist":
        return cfg.ori_hist_blur_sigma
    if name.startswith("level"):
        return cfg.incremental_sigmas()[int(name[len("level"):]) - 1]
    raise KeyError(name)


def static_table(name: str, cfg: SiftConfig):
    """The port's numpy copy of one static host table, by name.

    Names: ``taps/<s>`` (1D blur taps) and ``band/<s>/<dim>`` (the banded
    blur matrix for an axis of length dim), where <s> is ``initial``,
    ``level<j>`` (the blur raising level j-1 to j) or ``ori_hist``;
    ``level_sigmas``, ``patch_grid``, ``sphere_mask``, ``ori_dirs`` and
    ``spatial_weights`` (the GoH tables).
    """
    import numpy as np

    from sift3d_torch.kernels import descriptor, gauss, patch

    parts = name.split("/")
    if parts[0] == "taps":
        precision = 0.01 if parts[1] == "ori_hist" else cfg.blur_precision
        return gauss.gaussian_kernel_1d(_blur_sigma(cfg, parts[1]), precision)
    if parts[0] == "band":
        return gauss.banded_matrix(
            int(parts[2]), _blur_sigma(cfg, parts[1]), cfg.blur_precision
        )
    fixed = {
        "level_sigmas": lambda: np.asarray(cfg.level_sigmas(), np.float32),
        "patch_grid": patch.patch_grid,
        "sphere_mask": patch.sphere_mask,
        "ori_dirs": lambda: descriptor.ORI_DIRS,
        "spatial_weights": descriptor.spatial_weight_table,
    }
    return fixed[name]()


# The reference config's fields that the port does not read, at the
# values its fixed shapes and its f32 arithmetic implement.
UNREAD_DEFAULTS = {
    "blur_matmul_precision": None,
    "min_octave_dim": 3,
    "patch_dim": 11,
    "patch_scale_factor": 2.0,
    "descriptor_size": 64,
    "goh_spatial_bins": 2,
    "goh_orientation_bins": 8,
    "brief_blur_sigma": 0.95,
    "brief_method": 2,
    "max_candidates_per_level": 8192,
    "feature_chunk": 1024,
    "union_chunk": 4096,
    "knn_neighbors": 5,
    "max_matches": 3000,
    "ratio_compat_log_scale": math.log(1.5),
    "ratio_compat_shift": 0.5,
    "hough_thres_scale": 1.0,
    "hough_thres_trans": 2.0,
    "hough_thres_orien": 0.7,
    "softvote_eta": 1.0,
    "dtype": "float32",
}


def from_numpy_state(cfg_fields: dict, tables: dict) -> SiftConfig:
    """Build the port's config from another implementation's state.

    cfg_fields: config fields by name; the port's own are taken, the
    others must be in UNREAD_DEFAULTS and hold that value (else
    ValueError: the port would silently not do what they ask). tables:
    numpy arrays keyed by :func:`static_table` names. Each table must equal
    the port's own, derived from the same config by the same formulas,
    exactly (dtype, shape and every value); a mismatch raises ValueError.
    """
    import numpy as np

    own = {f.name for f in dataclasses.fields(SiftConfig)}
    for name, value in cfg_fields.items():
        if name not in own and (name not in UNREAD_DEFAULTS or value != UNREAD_DEFAULTS[name]):
            raise ValueError(f"config field {name}={value!r} is not supported by the port")
    cfg = SiftConfig(**{k: v for k, v in cfg_fields.items() if k in own})
    for name, want in tables.items():
        got = static_table(name, cfg)
        want = np.asarray(want)
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            raise ValueError(f"static table {name!r} differs from the port's")
    return cfg
