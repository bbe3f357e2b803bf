"""Task types, result transport and the inline runtime."""
