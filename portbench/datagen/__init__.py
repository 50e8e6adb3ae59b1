"""Generators of the benchmark's data, one module a datagen script, found
by the ``task`` a configuration file names."""
