"""Traffic generators, one module a kind, named by a mix's ``generator``."""
