"""Communication decisions (the policy vocabulary)."""
