"""The checker handle and its builder."""
