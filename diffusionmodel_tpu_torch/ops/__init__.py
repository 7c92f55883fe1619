"""Plain tensor ops shared by the port's layers."""
