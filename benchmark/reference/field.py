"""BN254's two prime fields and the reduction rule of the upstream inputs."""
from __future__ import annotations

# scalar field r: the circuit's native field (upstream internal/helpers.go:15)
P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# base field q: coordinates of curve points
P_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# the curve parameter u (ate loop count 6u + 2)
BN_U = 4965661367192848881


def big_to_ff(x: int, p: int = P_FR) -> int:
    """BigToFF (upstream internal/helpers.go:17-26): x == p -> 0, x in
    [0, p) -> x, otherwise x mod p."""
    if x == p:
        return 0
    if 0 <= x < p:
        return x
    return x % p


def inv(a: int, p: int) -> int:
    if a % p == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, p)
