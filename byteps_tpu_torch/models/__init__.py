"""Models of the port: the transformer core and BERT."""
