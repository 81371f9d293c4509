"""The system under test, set up on the card as a restarted server sets it
up: the kernels loaded, the circuit built, the key read as zkey bytes and
ingested (native ordering, the A/B-only quotient), a DeviceProver on the
card, and behind it a ReplayProver with a captured step for every batch
size the cell's traffic uses.

The key's bytes are the configuration's committed zkey.  They do not ride
in the checkout: the first run in a checkout rebuilds them with the
program's own dev_setup, zkey_from_pk and write_zkey, requires their
sha256 to equal the configuration's, and keeps them in the benchmark's
cache; every run then reads and ingests them.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path


@contextmanager
def span(spans: dict, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def build_native(root: Path) -> None:
    """The program's host library (the dev key's fixed-base products),
    built once in the checkout without OpenMP, which the card's host
    lacks."""
    if (root / "native" / "build" / "libzkhost.so").exists():
        return
    done = subprocess.run(
        ["make", "-C", str(root / "native"), "CXX=g++",
         "CXXFLAGS=-O3 -fPIC -shared -std=c++17 -march=native"],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{done.stderr[-2000:]}")


def counters() -> dict:
    """The program's launch counters, by kernel and by shape."""
    from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
    return {"launches": dict(K.LAUNCHES), "mont": dict(K.MONT_SHAPES),
            "padd": dict(K.PADD_SHAPES), "fold": dict(K.FOLD_SHAPES),
            "scalar": dict(K.SCALAR_SHAPES)}


def counted_since(after: dict, before: dict) -> dict:
    return {group: {k: v - before[group].get(k, 0)
                    for k, v in after[group].items()
                    if v != before[group].get(k, 0)}
            for group in after}


def zkey_bytes(config: dict, circuit, cache: Path) -> bytes:
    """The configuration's key as zkey bytes, from the cache, built there
    first if need be; raises unless their sha256 is the configuration's."""
    want = config["key"]["sha256"]
    path = cache / f"{config['name']}.zkey"
    if not path.exists():
        from zkfranchise_tpu_torch.groth16 import setup
        from zkfranchise_tpu_torch.utils import serialize, zkey_compat
        pk, vk = setup.dev_setup(circuit.cs)
        data = serialize.write_zkey(zkey_compat.zkey_from_pk(circuit.cs,
                                                             pk, vk))
        got = hashlib.sha256(data).hexdigest()
        if got != want:
            raise RuntimeError(f"{config['name']}: the rebuilt key's sha256 "
                               f"is {got}, the configuration's {want}")
        cache.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part")
        tmp.write_bytes(data)
        os.replace(tmp, path)
        return data
    data = path.read_bytes()
    got = hashlib.sha256(data).hexdigest()
    if got != want:
        raise RuntimeError(f"{path}: sha256 {got}, the configuration's "
                           f"{want}: remove the file to rebuild it")
    return data


@dataclass
class Program:
    prover: object                 # ProofStream's prover (a ReplayProver)
    domain: int
    captured: dict = field(default_factory=dict)  # size: counter diff
    spans: dict = field(default_factory=dict)


def setup(root: Path, config: dict, sizes: list, vk: dict,
          cache: Path, spans: dict) -> Program:
    """The program as the cell serves it, every size of `sizes` captured.
    vk: the configuration's committed verification key, which the
    ingested key's must equal."""
    import torch
    from zkfranchise_tpu_torch.groth16.device import (DeviceProver,
                                                      ReplayProver)
    from zkfranchise_tpu_torch.models.census import CensusCircuit
    from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K
    from zkfranchise_tpu_torch.utils import zkey_compat

    with span(spans, "cuda"):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with span(spans, "kernels"):
        K._libs()
        build_native(root)
    with span(spans, "circuit"):
        circuit = CensusCircuit(config["nlevels"])
    with span(spans, "key_read"):
        data = zkey_bytes(config, circuit, cache)
    with span(spans, "key_ingest"):
        pk, got_vk, arrays = zkey_compat.ingest_zkey(data, ordering="native")
    del data
    if got_vk.to_dict() != vk:
        raise RuntimeError(f"{config['name']}: the ingested key's vk differs "
                           f"from the configuration's")
    if "c" in arrays:
        raise RuntimeError("an ingested zkey carries no C matrix")
    with span(spans, "prover"):
        prover = DeviceProver(circuit, pk, arrays=arrays, device="cuda")
    del pk, arrays
    program = Program(prover=None, domain=prover.pk_meta[2], spans=spans)
    marks: dict = {}

    def probe(batch: int, stage: str) -> None:
        if stage == "warmup":
            marks[batch] = counters()
        elif stage == "capture":
            program.captured[batch] = counted_since(counters(), marks[batch])

    replay = ReplayProver(prover, probe=probe)
    with span(spans, "captures"):
        for size in sizes:
            replay.step(size)
    for part in ("warmup_s", "capture_s", "instantiate_s"):
        spans[f"capture.{part}"] = sum(getattr(step, part)
                                       for step in replay.steps.values())
    spans["capture"] = sum(spans[f"capture.{part}"] for part in
                           ("warmup_s", "capture_s", "instantiate_s"))
    torch.cuda.synchronize()
    program.prover = replay
    return program
