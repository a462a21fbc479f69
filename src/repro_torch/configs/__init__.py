"""Per-architecture configurations the port serves."""
