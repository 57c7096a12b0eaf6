"""Executable protocol specification (pure Python, bit-exact, slow).

Every TPU kernel in the framework is tested against this module. The semantics
were derived from the reference's Cairo verifier + the golden proof artifact
(reference: src/stark_verifier/*.cairo, proofs/fib.bin) and validated against
its known-answer tests (tests/integration/test_verifier.cairo:104,108,44).
"""

from .field import GOLDILOCKS_PRIME, FieldSpec, gl
from .coin import RandomCoin
from . import hashing
