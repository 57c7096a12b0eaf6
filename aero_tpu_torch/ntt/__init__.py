from .ntt import ntt, intt, lde, lde_from_evals, ntt_plain, coset_pad
