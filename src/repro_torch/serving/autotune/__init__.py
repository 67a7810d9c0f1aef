"""Serving-stack autotuner (port of ``repro.serving.autotune``): the
paper's design-automation thesis aimed at the serving engine itself.

The engine's config space — page size, prefill chunk, expected
occupancy, KV-bit policy, mesh split, batch cap — was tuned by hand
until now. This package searches it the way HAQ searches bit policies:

* `space`     — typed `ServingConfig` candidates + `ConfigSpace`
                (choices, constraints, unit-hypercube encoding,
                `to_policy` lowering via the admission roofline, and the
                per-hardware JSON config I/O);
* `objective` — the fast feedback signal: `admission.step_latency`
                corrected by per-(kind, batch, q_len) calibration scale
                factors fitted on the target host by
                `telemetry.calibrate` (raw-roofline fallback, with a
                logged warning, when no calibration exists);
* `search`    — DDPG (`core/rl/ddpg.py`, the AMC/HAQ agent) plus a
                seeded evolutionary baseline; deterministic per seed;
* `validate`  — top-k candidates re-measured on the real engine (on the
                card: through the paged kernels), with the Spearman
                predicted-vs-measured rank correlation;
* `tune`      — the end-to-end calibrate -> search -> validate -> emit
                loop behind ``launch/serve.py --autotune`` and the
                bench's ``autotune`` section.

The searched winner ships as a per-hardware JSON config
(``--serving-config`` loads it), byte for byte the reference's record.
The mesh dimension spans the launched world, as the reference's spans
its devices: under ``torchrun`` ``launch/serve.py --autotune`` builds
``ConfigSpace(max_devices=WORLD_SIZE)``, every rank runs the same
search, a ``mesh_model = m`` candidate is measured on the sharded
engine over the first m ranks, and rank 0's numbers are every rank's
(`validate`), so all pick one winner, served as a loaded record is. In
one process a mesh candidate is wider than the world and skipped.
"""

from repro_torch.serving.autotune.objective import Objective, ScoredCandidate
from repro_torch.serving.autotune.search import (
    SearchResult,
    ddpg_search,
    evolutionary_search,
    search_serving_config,
)
from repro_torch.serving.autotune.space import (
    KV_POLICIES,
    ConfigSpace,
    ServingConfig,
    config_record,
    load_serving_config,
    save_serving_config,
)
from repro_torch.serving.autotune.tune import TuneResult, autotune_serving_config
from repro_torch.serving.autotune.validate import (
    MeasuredCandidate,
    measure_candidate,
    spearman,
    validate_candidates,
)

__all__ = [
    "ConfigSpace",
    "KV_POLICIES",
    "MeasuredCandidate",
    "Objective",
    "ScoredCandidate",
    "SearchResult",
    "ServingConfig",
    "TuneResult",
    "autotune_serving_config",
    "config_record",
    "ddpg_search",
    "evolutionary_search",
    "load_serving_config",
    "measure_candidate",
    "save_serving_config",
    "search_serving_config",
    "spearman",
    "validate_candidates",
]
