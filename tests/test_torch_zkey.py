"""The port's snarkjs containers (utils/serialize.py) and zkey adapter
(utils/zkey_compat.py) against the JAX package's at nlevels=4, from the
committed dev/4 proving key: same bytes, same parsed fields, same ingested
tables and arrays, the same A/B-only quotient.  Exact comparisons
throughout.  (The prover keyed from an ingested zkey proves in
test_torch_zkey_prove.py.)"""
import dataclasses
import io
import json
import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfranchise_tpu.groth16 import device as jdevice
from zkfranchise_tpu.groth16 import setup as jsetup
from zkfranchise_tpu.groth16 import verify as jverify
from zkfranchise_tpu.models.census import CensusCircuit as JaxCircuit
from zkfranchise_tpu.utils import serialize as jserialize
from zkfranchise_tpu.utils import zkey_compat as jzkey
from zkfranchise_tpu_torch import inputs as tinputs
from zkfranchise_tpu_torch.groth16 import device as tdevice
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.groth16 import verify as tverify
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import ec
from zkfranchise_tpu_torch.utils import serialize, zkey_compat

# small tensors: one intra-op thread per test worker (several workers
# share the machine's cores)
torch.set_num_threads(1)

NL = 4
ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev" / str(NL)
ZKEY_FIELDS = [f.name for f in dataclasses.fields(serialize.ZkeyData)]
PK_FIELDS = [f.name for f in dataclasses.fields(tsetup.ProvingKey)]


@pytest.fixture(scope="module")
def circuit():
    return CensusCircuit(NL)


@pytest.fixture(scope="module")
def keys():
    pk = tsetup.ProvingKey.load(ART / "proving_key.pkl")
    vk = tverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    return pk, vk


@pytest.fixture(scope="module")
def native_z(circuit, keys):
    return zkey_compat.zkey_from_pk(circuit.cs, *keys)


@pytest.fixture(scope="module")
def producer_bytes(circuit, native_z):
    """zkey bytes in the census-circom producer ordering."""
    perm = zkey_compat.census_circom_perm(circuit.cs)
    return serialize.write_zkey(zkey_compat.export_in_ordering(native_z,
                                                               perm))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's circuit, native zkey, permutation and producer
    bytes for the same committed key."""
    cs = JaxCircuit(NL).cs
    pk = jsetup.ProvingKey.load(ART / "proving_key.pkl")
    vk = jverify.VerifyingKey(
        json.loads((ART / "verification_key.json").read_text()))
    z = jzkey.zkey_from_pk(cs, pk, vk)
    perm = jzkey.census_circom_perm(cs)
    data = jserialize.write_zkey(jzkey.export_in_ordering(z, perm))
    return cs, z, perm, data


@pytest.fixture(scope="module")
def ingested(circuit, producer_bytes):
    return zkey_compat.ingest_zkey(producer_bytes, cs=circuit.cs,
                                   ordering="census-circom")


def _same_zkey(a, b):
    for name in ZKEY_FIELDS:
        assert getattr(a, name) == getattr(b, name), name


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in ("a", "b"):
        for x, y in zip(got[k], want[k]):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("num_constraints", "num_vars", "num_public"):
        assert got[k] == want[k]


def test_zkey_roundtrip_and_bytes_match_jax():
    """The container test of the JAX package, and the same bytes."""
    rng = random.Random(123)

    def g1():
        return ec.g1_mul(rng.randrange(1, ec.R_ORDER))

    def g2():
        return ec.g2_mul(rng.randrange(1, ec.R_ORDER))

    fields = dict(
        n_vars=5, n_public=2, domain=8,
        alpha_g1=g1(), beta_g1=g1(), beta_g2=g2(), gamma_g2=ec.G2_GEN,
        delta_g1=g1(), delta_g2=g2(), ic=[g1() for _ in range(3)],
        coeffs=[(0, 0, 1, 12345), (1, 2, 3, serialize.ff.P_FR - 1)],
        a_g1=[g1() for _ in range(5)] + [None],
        b_g1=[g1() for _ in range(5)], b_g2=[g2() for _ in range(5)],
        c_g1=[g1() for _ in range(2)], h_g1=[g1() for _ in range(8)])
    z = serialize.ZkeyData(**fields)
    data = serialize.write_zkey(z)
    assert data == jserialize.write_zkey(jserialize.ZkeyData(**fields))
    _same_zkey(serialize.read_zkey(data), z)
    _same_zkey(serialize.read_zkey(data), jserialize.read_zkey(data))


def test_ptau_roundtrip_and_bytes_match_jax():
    rng = random.Random(321)

    def g1():
        return ec.g1_mul(rng.randrange(1, ec.R_ORDER))

    def g2():
        return ec.g2_mul(rng.randrange(1, ec.R_ORDER))

    fields = dict(power=3, tau_g1=[g1() for _ in range(15)],
                  tau_g2=[g2() for _ in range(8)],
                  alpha_tau_g1=[g1() for _ in range(8)],
                  beta_tau_g1=[g1() for _ in range(8)], beta_g2=g2())
    data = serialize.write_ptau(serialize.PtauData(**fields))
    assert data == jserialize.write_ptau(jserialize.PtauData(**fields))
    back = serialize.read_ptau(data)
    for name, want in fields.items():
        assert getattr(back, name) == want, name
    with pytest.raises(AssertionError):
        serialize.read_zkey(data)                   # wrong magic


def test_census_perm_matches_jax(circuit, jax_side):
    perm = zkey_compat.census_circom_perm(circuit.cs)
    assert perm.dtype == jax_side[2].dtype
    assert np.array_equal(perm, jax_side[2])
    n, npub = circuit.cs.num_vars, circuit.cs.num_public
    assert np.array_equal(np.sort(perm), np.arange(n))
    assert not np.array_equal(perm, np.arange(n))      # really reorders
    assert np.array_equal(perm[:npub + 1], np.arange(npub + 1))
    inv = zkey_compat.invert_perm(perm)
    assert np.array_equal(inv[perm], np.arange(n))


def test_zkey_from_pk_and_written_bytes_match_jax(native_z, producer_bytes,
                                                  jax_side):
    _, jz, _, jdata = jax_side
    _same_zkey(native_z, jz)
    assert serialize.write_zkey(native_z) == jserialize.write_zkey(jz)
    assert producer_bytes == jdata


def test_read_and_permute_match_jax(circuit, native_z, producer_bytes,
                                    jax_side):
    """read_zkey and permute_zkey field by field; the round trip gives
    the native key back and the producer ordering really differs."""
    _, _, jperm, jdata = jax_side
    raw = serialize.read_zkey(producer_bytes)
    _same_zkey(raw, jserialize.read_zkey(jdata))
    perm = zkey_compat.census_circom_perm(circuit.cs)
    back = zkey_compat.permute_zkey(raw, perm)
    _same_zkey(back, jzkey.permute_zkey(jserialize.read_zkey(jdata), jperm))
    assert sorted(back.coeffs) == sorted(native_z.coeffs)
    for name in ("a_g1", "b_g1", "b_g2", "c_g1", "h_g1", "ic"):
        assert getattr(back, name) == getattr(native_z, name), name
    assert raw.a_g1 != native_z.a_g1
    assert sorted(raw.coeffs) != sorted(native_z.coeffs)


def test_ingested_tables_and_arrays_match_jax(keys, ingested, jax_side):
    """pk_from_zkey and arrays_from_zkey, field by field and array by
    array; the ingested key is the committed one."""
    jcs, _, _, jdata = jax_side
    pk, vk, arrays = ingested
    jpk, jvk, jarrays = jzkey.ingest_zkey(jdata, cs=jcs,
                                          ordering="census-circom")
    for name in PK_FIELDS:
        assert getattr(pk, name) == getattr(jpk, name), name
        assert getattr(pk, name) == getattr(keys[0], name), name
    assert vk.to_dict() == jvk.to_dict() == keys[1].to_dict()
    assert "c" not in arrays                       # zkeys carry only A/B
    _same_arrays(arrays, jarrays)
    assert arrays["a"][0].dtype == np.int32
    assert arrays["a"][2].shape[1:] == (21, 1)


def test_unadapted_ingest_is_wrong_ordering(keys, producer_bytes):
    pk_raw, _, _ = zkey_compat.ingest_zkey(producer_bytes, ordering="native")
    assert pk_raw.a_g1 != keys[0].a_g1
    with pytest.raises(ValueError):
        zkey_compat.ingest_zkey(producer_bytes, ordering="circom-3")


def test_ingest_spans_fill_the_process_totals(circuit, producer_bytes,
                                              monkeypatch):
    """ingest_zkey's parts, each a span: outside a recording they add to
    PROCESS's totals (ingest.permute only under the census-circom
    ordering); inside one they are records in order."""
    from zkfranchise_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics.PROCESS, "timers", {})
    zkey_compat.ingest_zkey(producer_bytes, ordering="native")
    parts = ["ingest.read_zkey", "ingest.pk_from_zkey",
             "ingest.arrays_from_zkey"]
    assert list(metrics.PROCESS.timers) == parts
    assert all(v > 0 for v in metrics.PROCESS.timers.values())
    buf = io.StringIO()
    with metrics.recording(metrics.Metrics(sink=buf)):
        zkey_compat.ingest_zkey(producer_bytes, cs=circuit.cs,
                                ordering="census-circom")
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["name"] for r in records] == \
        ["ingest.read_zkey", "ingest.permute", *parts[1:]]
    assert list(metrics.PROCESS.timers) == parts


def test_ab_only_quotient_matches_jax(circuit, ingested):
    """quotient_stage on the zkey's A/B arrays, through what
    DeviceProver(arrays=) makes of them, against the JAX quotient_stage
    on the same arrays: cz comes from mont_mul(az, bz) in both."""
    pk, _, arrays = ingested
    arrs = tinputs.batch_to_arrays(
        tinputs.mock_batch(NL, 2, seed=3, device="cpu"), NL)
    w = circuit.witness({k: torch.as_tensor(v) for k, v in arrs.items()})
    prover = tdevice.DeviceProver(circuit, pk, arrays=arrays, device="cpu")
    assert sorted(prover._arrays_dev) == ["a", "b"]
    assert prover._arrays_dev["a"][0].dtype == torch.int64
    q = tdevice.quotient_stage(prover._arrays_dev, pk.domain, w)
    want = jax.jit(lambda v: jdevice.quotient_stage(
        {k: arrays[k] for k in "ab"}, pk.domain, v))(jnp.asarray(w.numpy()))
    assert q.shape == (pk.domain, 21, 2)
    assert np.array_equal(np.asarray(want), q.numpy())
    # and equals the quotient from the circuit's own A, B and C
    full = tdevice.DeviceProver(circuit, pk, device="cpu")
    assert torch.equal(tdevice.quotient_stage(full._arrays_dev, pk.domain,
                                              w), q)


def test_zkey_keyed_prover_defaults_to_the_card(circuit, ingested):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    pk, _, arrays = ingested
    with pytest.raises(RuntimeError):
        tdevice.DeviceProver(circuit, pk, arrays=arrays)
