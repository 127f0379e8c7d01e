"""Model families of the port: BERT so far."""
