"""Device and dtype policy of the port."""
