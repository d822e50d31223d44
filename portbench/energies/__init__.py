"""Seeded input generators and work counts, one module an energy."""
