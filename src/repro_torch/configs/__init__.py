"""Model configurations the port serves (one module per arch id)."""
