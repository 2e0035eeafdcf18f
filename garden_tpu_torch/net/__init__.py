"""Client/server networking (host-side by nature)."""
