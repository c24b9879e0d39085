"""Render configuration.

One dataclass replaces the reference's three config tiers (compile-time
consts ``mod.rs:28,32,661``, GUI-validated inputs ``main.rs:157-179``, and
scene JSON). Defaults and validation limits match the GUI: res_y default 300
(width = res_y*3/2, ``main.rs:176``), spp default 100, res_y in [1,2000],
spp in [1,10000].
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class Resolution:
    height: int = 300
    width: int = 450  # height * 3 / 2

    @staticmethod
    def from_height(res_y: int) -> "Resolution":
        return Resolution(height=res_y, width=res_y * 3 // 2)

    @property
    def num_pixels(self) -> int:
        return self.height * self.width


# Validation limits (main.rs:157-170)
RES_Y_RANGE = (1, 2000)
SPP_RANGE = (1, 10000)


@dataclass(frozen=True)
class RenderConfig:
    """Everything the renderer needs besides the scene itself."""

    samples_per_pixel: int = 100
    resolution: Resolution = field(default_factory=Resolution)

    # Integrator constants (parity: mod.rs:28,661,676-683,737-758).
    # Back-face culling stays off unconditionally (USE_CULLING=false is a
    # compile-time const in the reference, mod.rs:28; the |det| epsilon
    # test in ops.intersect bakes the culling-off semantics).
    max_depth: int = 12
    rr_start_depth: int = 5  # Russian roulette when new_depth > 5

    # RNG
    seed: int = 0
    # MOCK_RANDOM fixture parity (mod.rs:31-55): deterministic 9-value
    # cycle instead of threefry; XLA backends only
    mock_random: bool = False

    # Estimator semantics: "shipped" = t > EPS_TRI_T + departed-triangle
    # exclusion (documented deviation, ops.intersect EPS_TRI_T comment);
    # "literal" = the reference's exact t > 0 acceptance (mod.rs:592),
    # phantom self-re-hits included. Literal is XLA-only (backend exact /
    # fast) and exists to quantify the deviation — see PARITY_REPORT.md.
    estimator: str = "shipped"

    # Execution
    backend: str = "auto"  # auto | pallas | fast | exact (render.pipeline)
    samples_per_pass: int = 0  # 0 = auto-pick (kernel pass / memory budget)
    pixel_chunk: int = 0  # 0 = whole frame per dispatch
    # matmul precision for the XLA intersection paths ("highest" | "high" |
    # "default"), wired through ops.intersect.set_precision. "highest" is
    # full f32; on an H100 "default" means TF32 (about three decimal
    # digits), which visibly misses geometry. `exact` and every parity
    # comparison run at "highest"; the GPU kernel has no matmul.
    f32_precision: str = "highest"
    validate: bool = False  # enforce GUI ranges

    def validated(self) -> "RenderConfig":
        if self.estimator not in ("shipped", "literal"):
            raise ValueError(
                f"estimator must be 'shipped' or 'literal', got {self.estimator!r}"
            )
        if self.validate:
            if not RES_Y_RANGE[0] <= self.resolution.height <= RES_Y_RANGE[1]:
                raise ValueError(
                    f"res_y must be in {RES_Y_RANGE}, got {self.resolution.height}"
                )
            if not SPP_RANGE[0] <= self.samples_per_pixel <= SPP_RANGE[1]:
                raise ValueError(
                    f"spp must be in {SPP_RANGE}, got {self.samples_per_pixel}"
                )
        return self

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
