"""The paper's own client application: vortex-method FMM configuration.

Matches the strong-scaling experiment of PetFMM §7: N = 765,625 particles
(875^2 lattice), tree level 10, cut (root) level 4, p = 17 expansion terms.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FMMConfig:
    name: str = "petfmm-vortex"
    num_particles: int = 765_625
    level: int = 10
    cut_level: int = 4
    p: int = 17
    sigma: float = 0.02
    spacing_ratio: float = 0.8


CONFIG = FMMConfig()
SMOKE_CONFIG = dataclasses.replace(CONFIG, num_particles=2_500, level=4,
                                   cut_level=2, p=8)
