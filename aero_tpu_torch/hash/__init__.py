from .blake2s import (blake2s_words, hash_columns_t, merge_level_t,
                      leading_zeros_t, grind_pow)
