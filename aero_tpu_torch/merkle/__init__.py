from .tree import ResidentMerkleTree, commit_columns
