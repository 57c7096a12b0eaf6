from .gl import (P, EPSILON, as_i64, scalar, from_u64, to_u64, from_limbs,
                 gf_full, gf_zeros, gf_concat, gf_take, gf_where, gf_reshape,
                 canonicalize, add, sub, neg, mul, square, mul_scalar,
                 mul_pow2_const, pow_const, pow_loop, inv, batch_inv,
                 gf_cumprod, gf_cumsum, gf_sum, power_series,
                 power_series_rows, eval_polys_at, eval_polys_multi,
                 eval_polys_multi_plain)
