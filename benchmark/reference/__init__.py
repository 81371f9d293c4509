"""The benchmark's plain reference for the census statement and Groth16.

Plain Python integers only: the BN254 fields, the circomlib Poseidon
hash (t = 3..5), vocdoni arbo's sparse Merkle tree (build, siblings, root
check), the eight public signals of a voter, and Groth16 verification
with an optimal-ate pairing against a snarkjs ``verification_key.json``.

It imports nothing of the program under test: what it knows of the
statement comes from the upstream circuit (vocdoni zk-franchise-proof-
circuit ``circuit/census.circom``) and the snarkjs formats, so a fault in
the program cannot hide in the yardstick.  Parts are frozen copies of the
port's host code (``ops/ff.py``, ``ops/poseidon_constants.py``,
``utils/arbo.py``, ``utils/smt.py``, ``ops/ec.py``, ``ops/pairing.py``,
``groth16/verify.py``) as they stood when the benchmark was defined.
"""
