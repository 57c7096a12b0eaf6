from .tree import (ResidentMerkleTree, commit_columns, commit_digests,
                   commit_rows)
