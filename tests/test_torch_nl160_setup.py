"""The host side of the dev key at nlevels=160: the port's dev_setup gives
the committed dev/160 verification key field by field (so a key derived
on the card's host proves against it), with the seconds of each part, and
its native-ordered zkey bytes equal the committed dev/160 proving_key.zkey
byte for byte (so the card serves from exactly the deployment's key
without the file); the native library's conversions (one to_bytes or
from_bytes an int) equal the JAX package's limb by limb; the pairing's
final exponentiation, split into its easy and hard parts, equals the JAX
package's."""
import hashlib
import json
import pathlib
import random

import numpy as np
import pytest

from zkfranchise_tpu.ops import pairing as jpairing
from zkfranchise_tpu.utils import native as jnative
from zkfranchise_tpu_torch.groth16 import setup as tsetup
from zkfranchise_tpu_torch.models.census import CensusCircuit
from zkfranchise_tpu_torch.ops import ec, pairing
from zkfranchise_tpu_torch.utils import native, serialize, zkey_compat

ART = pathlib.Path(__file__).resolve().parent.parent / "artifacts" / \
    "zkCensus" / "dev"


@pytest.fixture(scope="module")
def dev160():
    """(cs, pk, vk, seconds by part) of one dev_setup at nlevels=160."""
    if not native.available():
        pytest.skip("native/build/libzkhost.so did not build")
    cs = CensusCircuit(160).cs
    parts: dict = {}
    pk, vk = tsetup.dev_setup(cs, seconds=parts)
    return cs, pk, vk, parts


def test_dev_setup_160_vk_equals_committed(dev160):
    _, _, vk, parts = dev160
    want = json.loads((ART / "160" / "verification_key.json").read_text())
    assert vk.to_dict() == want
    assert set(parts) == {"rows_and_lagrange", "g1_products", "g2_products",
                          "conversions", "key"}
    assert all(v >= 0 for v in parts.values())


def test_dev_setup_160_zkey_equals_committed(dev160):
    """The deployment's key (Config().artifact_dir) rebuilt from the dev
    key in native ordering, as chip_smoke.py's phase stream160 rebuilds
    it, is the committed file byte for byte, and its sha256 is the one
    the committed manifest gives (what the card, without the file,
    compares with)."""
    cs, pk, vk, _ = dev160
    data = serialize.write_zkey(zkey_compat.zkey_from_pk(cs, pk, vk))
    assert data == (ART / "160" / "proving_key.zkey").read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    assert f"- proving_key.zkey: `{digest}`" in \
        (ART / "circuits-info.md").read_text()


def _points(rng):
    g1 = [ec.g1_mul(rng.randrange(1, 1 << 200)) for _ in range(12)] + [None]
    g2 = [ec.g2_mul(rng.randrange(1, 1 << 200)) for _ in range(6)] + [None]
    rng.shuffle(g1)
    rng.shuffle(g2)
    return g1, g2


def test_native_conversions_equal_jax():
    rng = random.Random(160)
    g1, g2 = _points(rng)
    # field elements, 0, the top of the range and values the mask cuts
    scalars = [rng.randrange(1 << 256) for _ in range(40)] + \
        [0, (1 << 256) - 1, 1 << 256, -5, (1 << 300) + 7]
    assert np.array_equal(native._scalars_to_u64(scalars),
                          jnative._scalars_to_u64(scalars))
    rows = jnative._scalars_to_u64(scalars[:40])
    assert native._u64_to_ints(rows) == [jnative._u64_to_int(r)
                                         for r in rows]
    for pt in g1:
        row = jnative._g1_to_u64(pt)
        assert np.array_equal(native._g1_to_u64(pt), row)
        assert native._g1_from_u64(row) == jnative._g1_from_u64(row)
    for pt in g2:
        row = jnative._g2_to_u64(pt)
        assert np.array_equal(native._g2_to_u64(pt), row)
        assert native._g2_from_u64(row) == jnative._g2_from_u64(row)
    assert np.array_equal(native._g1_pack(g1),
                          np.stack([jnative._g1_to_u64(p) for p in g1]))
    assert np.array_equal(native._g2_pack(g2),
                          np.stack([jnative._g2_to_u64(p) for p in g2]))
    assert native._g1_unpack(native._g1_pack(g1)) == g1
    assert native._g2_unpack(native._g2_pack(g2)) == g2


def test_native_batches_equal_jax():
    if not native.available():
        pytest.skip("native/build/libzkhost.so did not build")
    rng = random.Random(161)
    g1, g2 = _points(rng)
    ks = [rng.randrange(1 << 254) for _ in range(len(g1))]
    assert native.g1_fixed_base_mul(ks) == jnative.g1_fixed_base_mul(ks)
    assert native.g2_fixed_base_mul(ks[:4]) == \
        jnative.g2_fixed_base_mul(ks[:4])
    assert native.g1_scale_batch(ks, g1) == jnative.g1_scale_batch(ks, g1)
    assert native.g2_add_batch(g2, g2[::-1]) == \
        jnative.g2_add_batch(g2, g2[::-1])
    assert native.g1_msm(ks, g1) == jnative.g1_msm(ks, g1)
    ids = [i % 3 for i in range(len(g2))]
    assert native.g2_segsum(g2, ids, 4) == jnative.g2_segsum(g2, ids, 4)


def test_final_exponentiation_equals_jax():
    rng = random.Random(162)
    for _ in range(2):
        f = [rng.randrange(pairing.Q) for _ in range(12)]
        assert pairing.final_exponentiate(f) == \
            jpairing.final_exponentiate(f)
    assert pairing.final_exponentiate(pairing.fq12_zero()) == \
        jpairing.final_exponentiate(jpairing.fq12_zero())
    p, q = ec.g1_mul(5), ec.g2_mul(7)
    assert pairing.pairing(p, q) == jpairing.pairing(p, q)
    assert pairing.multi_pairing_check(
        [(p, q), (ec.G1.neg(ec.g1_mul(35)), ec.G2_GEN)])
    assert not pairing.multi_pairing_check(
        [(p, q), (ec.G1.neg(ec.g1_mul(36)), ec.G2_GEN)])
