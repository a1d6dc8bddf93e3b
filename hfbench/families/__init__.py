"""Model families: each builds its models through the port's public API and
makes its weights and data from the seed."""
