"""Framework configuration.

One dataclass replaces upstream's scattered environment variables
(CIRCUIT_NAME/ENVIRONMENT/NLEVELS/KEYSIZE in zk_census_test.go and
ENVIRONMENT in circuit/circuit-compiler.sh), with the same defaults and
the same artifact directory layout artifacts/<name>/<env>/<nlevels>/.

Unlike upstream (where NLEVELS/KEYSIZE only changed the artifact path),
every knob here takes effect.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Config:
    circuit_name: str = "zkCensus"
    environment: str = "dev"
    n_levels: int = 160
    key_size: int = 20          # bytes; reference default KEYSIZE=20
    batch_size: int = 16        # voters per proving step
    # mesh shape: (data, model) — voter DP x proving-key sharding
    mesh_data: int = 1
    mesh_model: int = 1
    artifacts_root: Path = field(
        default_factory=lambda: Path(os.environ.get(
            "ZKF_ARTIFACTS", Path(__file__).resolve().parent.parent
            / "artifacts")))

    @staticmethod
    def from_env() -> "Config":
        """Reference-compatible env names plus mesh/batch extensions."""
        cfg = Config(
            circuit_name=os.environ.get("CIRCUIT_NAME", "zkCensus"),
            environment=os.environ.get("ENVIRONMENT", "dev"),
            n_levels=int(os.environ.get("NLEVELS", "160")),
            key_size=int(os.environ.get("KEYSIZE", "20")),
            batch_size=int(os.environ.get("BATCH_SIZE", "16")),
            mesh_data=int(os.environ.get("MESH_DATA", "1")),
            mesh_model=int(os.environ.get("MESH_MODEL", "1")),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        # the bounds upstream enforces (zk_census_test.go:27-48)
        if self.n_levels < 10:
            raise ValueError("nLevels must be >= 10 (reference bound); "
                             "smaller values allowed via Config() directly")
        if self.key_size * 8 > self.n_levels:
            raise ValueError("key size (bits) must fit in the tree depth")

    @property
    def artifact_dir(self) -> Path:
        return (self.artifacts_root / self.circuit_name / self.environment
                / str(self.n_levels))
