"""Plain float32 references of the port's models, in plain torch, that
the tests hold the port against; each imports nothing else of the port."""
