"""Applications of the port: the gNB slot simulator (`gnb_sim`)."""
