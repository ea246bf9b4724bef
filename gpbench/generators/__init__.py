"""General traffic generators. A traffic mix is a data file under
``traffic/`` that names one of these and gives its parameters."""
