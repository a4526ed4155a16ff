"""Analysis of a traced step: the H100 roofline (``roofline``) and the
cost, memory and collective accounting that takes the place of the
reference's HLO analysis (``hlo``)."""
