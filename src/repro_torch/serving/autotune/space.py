"""Typed config space for the serving-stack autotuner (port of
``repro.serving.autotune.space``).

A `ServingConfig` is one point in the engine's hand-tunable knob space —
page size, prefill chunk, expected occupancy, KV-bit policy, mesh split,
and the in-flight batch cap. `ConfigSpace` owns the per-dimension choice
lists (filtered to what the model/hardware pair admits: chunks never
exceed the padding bucket, mesh splits must divide ``kv_heads``),
encodes/decodes candidates to the unit hypercube the DDPG agent acts in,
and lowers a candidate to a full `AdmissionPolicy` via the same
`derive_policy` roofline the engine serves with — so a searched config
is, by construction, the same object a hand-picked one is.

Per-hardware configs serialize to JSON (`config_record` /
`save_serving_config` / `load_serving_config`): the artifact the search
emits and ``launch/serve.py --serving-config`` loads back.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware_model import Hardware
from repro_torch.serving.engine.admission import AdmissionPolicy, \
    derive_policy

# symbolic KV-pool policies; resolved to derive_policy(kv_bits=...) values
# by ConfigSpace.kv_bits_for (the "haq" tuple is the deterministic
# sensitivity-gated back-off from serving/kvquant, episodes=0 — no search
# inside the search)
KV_POLICIES = ("fp16", "int8", "haq")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One candidate: the engine knobs the autotuner is allowed to move.

    Everything else in `AdmissionPolicy` (num_pages, max_batch, quant
    bits) stays *derived* — the roofline answers those once these are
    fixed, exactly as it does for the hand-picked defaults.
    """

    page_size: int
    prefill_chunk: int
    expected_occupancy: float
    kv_policy: str
    mesh_model: int
    max_batch_cap: int

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ServingConfig":
        return cls(
            page_size=int(d["page_size"]),
            prefill_chunk=int(d["prefill_chunk"]),
            expected_occupancy=float(d["expected_occupancy"]),
            kv_policy=str(d["kv_policy"]),
            mesh_model=int(d["mesh_model"]),
            max_batch_cap=int(d["max_batch_cap"]),
        )

    def sort_key(self) -> Tuple:
        """Total order for deterministic tie-breaks in search rankings."""
        return dataclasses.astuple(self)


class ConfigSpace:
    """The discrete candidate space over one (model config, hardware,
    max_model_len) serving target.

    ``max_devices`` bounds the mesh dimension (1 on a single-device
    host, so the dimension collapses to its only legal choice; the
    autotuner's search passes 1, ``--serving-config`` the launched
    world's size);
    ``max_batch_cap`` bounds the batch-cap dimension (the bench/serve
    CLI cap, not the roofline's — `to_policy` takes the min of both).
    """

    def __init__(
        self,
        cfg,
        hw: Hardware,
        *,
        max_model_len: int,
        max_devices: int = 1,
        max_batch_cap: int = 8,
        param_bytes: Optional[int] = None,
        page_sizes: Sequence[int] = (8, 16, 32, 64),
        prefill_chunks: Sequence[int] = (16, 32, 64, 128, 256, 512),
        occupancies: Sequence[float] = (0.25, 0.5, 0.75, 1.0),
        kv_policies: Sequence[str] = KV_POLICIES,
    ):
        self.cfg = cfg
        self.hw = hw
        self.max_model_len = int(max_model_len)
        self.max_devices = int(max_devices)
        self.max_batch_cap = int(max_batch_cap)
        self.param_bytes = param_bytes
        unknown = [k for k in kv_policies if k not in KV_POLICIES]
        if unknown:
            raise ValueError(f"unknown kv policies {unknown}")
        page_sizes = tuple(
            p for p in sorted(set(page_sizes)) if 0 < p <= max_model_len
        )
        chunks = tuple(
            c
            for c in sorted(set(prefill_chunks))
            if 0 < c <= max_model_len  # chunk <= bucket, by construction
        )
        meshes = tuple(
            m
            for m in (1, 2, 4, 8, 16)
            if m <= self.max_devices and cfg.num_kv_heads % m == 0
        )
        caps = tuple(
            b for b in (1, 2, 4, 8, 16, 32, 64) if b <= self.max_batch_cap
        )
        if self.max_batch_cap not in caps:
            caps = caps + (self.max_batch_cap,)
        if not (page_sizes and chunks and meshes and caps):
            raise ValueError(
                f"empty config space for {cfg.name} @ "
                f"max_model_len={max_model_len}"
            )
        # ordered knob dimensions: (name, choice tuple). This IS the
        # encoding — vectors, indices, and the DDPG walk all follow it.
        self.dims: Tuple[Tuple[str, Tuple], ...] = (
            ("page_size", page_sizes),
            ("prefill_chunk", chunks),
            ("expected_occupancy", tuple(sorted(set(occupancies)))),
            ("kv_policy", tuple(kv_policies)),
            ("mesh_model", meshes),
            ("max_batch_cap", caps),
        )
        self._kv_bits_memo: Dict[str, object] = {}

    # ------------------------------------------------------------ encoding --
    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def size(self) -> int:
        n = 1
        for _, choices in self.dims:
            n *= len(choices)
        return n

    def from_indices(self, idxs: Sequence[int]) -> ServingConfig:
        vals = {}
        for (name, choices), i in zip(self.dims, idxs):
            vals[name] = choices[max(0, min(int(i), len(choices) - 1))]
        return ServingConfig(**vals)

    def indices(self, c: ServingConfig) -> List[int]:
        out = []
        for name, choices in self.dims:
            val = getattr(c, name)
            try:
                out.append(choices.index(val))
            except ValueError:
                raise ValueError(
                    f"{name}={val!r} is not a choice of this space "
                    f"(choices: {choices})"
                ) from None
        return out

    def encode(self, c: ServingConfig) -> np.ndarray:
        """Config -> unit-hypercube vector (one coordinate per knob,
        index normalized to [0, 1]; single-choice dims encode as 0)."""
        vec = []
        for (name, choices), i in zip(self.dims, self.indices(c)):
            vec.append(i / (len(choices) - 1) if len(choices) > 1 else 0.0)
        return np.asarray(vec, np.float64)

    def decode(self, vec: Sequence[float]) -> ServingConfig:
        """Unit-hypercube vector -> nearest config (rounds each
        coordinate onto its choice grid; exact inverse of `encode`)."""
        vec = np.asarray(vec, np.float64)
        if vec.shape != (self.num_dims,):
            raise ValueError(
                f"expected a {self.num_dims}-dim vector, got {vec.shape}"
            )
        idxs = []
        for (name, choices), v in zip(self.dims, vec):
            v = float(min(max(v, 0.0), 1.0))
            idxs.append(int(round(v * (len(choices) - 1))))
        return self.from_indices(idxs)

    def sample(self, rng: np.random.Generator) -> ServingConfig:
        return self.from_indices(
            [int(rng.integers(len(ch))) for _, ch in self.dims]
        )

    def default(self) -> ServingConfig:
        """The hand-picked baseline as a point of this space: page 16,
        the roofline-derived prefill chunk (snapped onto the chunk
        grid), 0.5 occupancy, the exact fp pool, no mesh split, and the
        full batch cap — the config every engine in this repo ran with
        before the autotuner existed."""
        pages = dict(self.dims)["page_size"]
        page = 16 if 16 in pages else pages[len(pages) // 2]
        chunks = dict(self.dims)["prefill_chunk"]
        try:
            derived = derive_policy(
                self.cfg,
                self.hw,
                max_model_len=self.max_model_len,
                page_size=page,
                param_bytes=self.param_bytes,
            ).prefill_chunk
        except (ValueError, NotImplementedError):
            derived = chunks[0]
        chunk = max(
            (c for c in chunks if c <= derived), default=chunks[0]
        )
        occs = dict(self.dims)["expected_occupancy"]
        occ = 0.5 if 0.5 in occs else occs[len(occs) // 2]
        kvs = dict(self.dims)["kv_policy"]
        return ServingConfig(
            page_size=page,
            prefill_chunk=chunk,
            expected_occupancy=occ,
            kv_policy="fp16" if "fp16" in kvs else kvs[0],
            mesh_model=1,
            max_batch_cap=self.max_batch_cap,
        )

    # --------------------------------------------------------- constraints --
    def kv_bits_for(self, kv_policy: str):
        """Resolve a symbolic KV policy to derive_policy's kv_bits value:
        None (bf16), 8 (uniform int8), or the deterministic
        sensitivity-gated HAQ tuple (episodes=0 back-off — local-window
        slots int4, global slots int8)."""
        if kv_policy not in self._kv_bits_memo:
            if kv_policy == "fp16":
                bits = None
            elif kv_policy == "int8":
                bits = 8
            elif kv_policy == "haq":
                from repro_torch.serving.kvquant import search_kv_policy

                bits = search_kv_policy(
                    self.cfg,
                    self.hw,
                    max_model_len=self.max_model_len,
                    episodes=0,
                    budget_frac=0.4,
                )["bits"]
            else:
                raise ValueError(f"unknown kv policy {kv_policy!r}")
            self._kv_bits_memo[kv_policy] = bits
        return self._kv_bits_memo[kv_policy]

    def violations(self, c: ServingConfig) -> Tuple[str, ...]:
        """Constraint check; empty tuple = admissible. Cheap structural
        checks first (membership, divisibility, chunk <= bucket), then
        the HBM roofline via `derive_policy` itself — the same ValueError
        that would reject a hand-picked config rejects a searched one."""
        v = []
        for name, choices in self.dims:
            if getattr(c, name) not in choices:
                v.append(f"{name}={getattr(c, name)!r} not in {choices}")
        if v:
            return tuple(v)
        if c.prefill_chunk > self.max_model_len:
            v.append(
                f"prefill_chunk {c.prefill_chunk} exceeds the "
                f"{self.max_model_len}-token bucket"
            )
        if self.cfg.num_kv_heads % c.mesh_model:
            v.append(
                f"mesh_model={c.mesh_model} does not divide "
                f"kv_heads={self.cfg.num_kv_heads}"
            )
        if not 0.0 < c.expected_occupancy <= 1.0:
            v.append(
                f"expected_occupancy={c.expected_occupancy} not in (0, 1]"
            )
        if not v:
            try:
                self.to_policy(c)
            except (ValueError, NotImplementedError) as e:
                v.append(f"roofline-infeasible: {e}")
        return tuple(v)

    def to_policy(self, c: ServingConfig) -> AdmissionPolicy:
        """Lower a candidate to the full admission policy: derive pool
        capacity / batch / weight bits from the roofline at the
        candidate's knobs, then pin the searched chunk and cap the
        in-flight batch."""
        policy = derive_policy(
            self.cfg,
            self.hw,
            max_model_len=self.max_model_len,
            page_size=c.page_size,
            expected_occupancy=c.expected_occupancy,
            param_bytes=self.param_bytes,
            kv_bits=self.kv_bits_for(c.kv_policy),
            mesh_model=c.mesh_model,
        )
        return dataclasses.replace(
            policy,
            max_batch=max(min(policy.max_batch, c.max_batch_cap), 1),
            prefill_chunk=c.prefill_chunk,
        )


# ------------------------------------------------------------- config I/O --
CONFIG_SCHEMA = 1


def config_record(
    space: ConfigSpace, c: ServingConfig, **provenance
) -> Dict:
    """A per-hardware serving config as a JSON-serializable record: the
    knobs plus the target they were searched for and how (budget, seed,
    predicted/measured scores — whatever the caller recorded)."""
    bits = space.kv_bits_for(c.kv_policy)
    return {
        "schema": CONFIG_SCHEMA,
        "hw": space.hw.name,
        "arch": space.cfg.name,
        "max_model_len": space.max_model_len,
        "knobs": c.as_dict(),
        "kv_bits": list(bits) if isinstance(bits, tuple) else bits,
        "provenance": dict(provenance),
    }


def save_serving_config(path: str, record: Dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)


def load_serving_config(path: str) -> Tuple[ServingConfig, Dict]:
    """Read a config JSON back; returns (knobs, full record). The caller
    owns compatibility checks (hw/arch/max_model_len match) — the record
    carries them for exactly that."""
    with open(path) as f:
        record = json.load(f)
    if record.get("schema") != CONFIG_SCHEMA:
        raise ValueError(
            f"{path}: serving-config schema "
            f"{record.get('schema')!r} != {CONFIG_SCHEMA}"
        )
    return ServingConfig.from_dict(record["knobs"]), record
