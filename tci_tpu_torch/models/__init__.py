"""L3-L4: tensor-train container, batched TT evaluation, global pivot
search and TCI2."""
