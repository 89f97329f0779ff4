"""Small framework-free helpers the port keeps its own copies of."""
