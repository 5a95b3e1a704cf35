"""Utilities: the input-corruption toolkit and focal-length averaging."""
