"""text_us_per_query: host time of the text layer a query, from the
harness's span around its own call of ``fast_tokenize_texts`` on the
window's sets, grouped by language as the router groups them."""


def read(trace, inputs):
    s = trace.spans.get("text_s_per_query")
    return s * 1e6 if s else None
