"""Debug scenarios: small worlds that exercise one part of the simulator."""
