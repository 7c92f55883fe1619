"""Model families of the port beyond the main ContextUnet (``nn``)."""
