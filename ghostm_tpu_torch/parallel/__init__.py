"""The distributed search: the ("data", "db") grid of ranks (mesh), its
step (search) and the starter of local ranks (launch)."""
