"""The card's peak rates and the roofline terms over them."""
