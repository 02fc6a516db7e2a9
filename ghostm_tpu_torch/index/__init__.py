"""Index build, storage and (de)serialisation (numpy, shared on-disk format)."""
