"""Device physical operators (Torch*Exec)."""
