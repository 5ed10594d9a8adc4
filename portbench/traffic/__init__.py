"""The benchmark's seeded traffic generators (volumes, .key sets)."""
