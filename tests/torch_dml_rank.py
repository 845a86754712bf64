"""One rank of ``tests/test_torch_dml.py``'s distributed DML case, run as
a script: the port only, never jax or ``nds_tpu``.

The rank joins the launch environment's gloo world, registers the port
generator's SF0.01 store_sales (sharded: above the threshold) and
date_dim, runs ``SELECT`` before and after ``STMTS`` through
``make_distributed_factory`` and pickles the results:

    python tests/torch_dml_rank.py <rank> <world> <out.pkl>
"""

import pickle
import sys

SF = 0.01
SELECT = (
    "select d_year, count(*) c, sum(ss_net_paid) s, "
    "sum(ss_sales_price) p from store_sales join date_dim "
    "on ss_sold_date_sk = d_date_sk group by d_year order by d_year")
STMTS = [
    "delete from store_sales where ss_sold_date_sk >= "
    "(select min(d_date_sk) from date_dim where d_date between "
    "'1999-01-01' and '1999-06-30') and ss_sold_date_sk <= "
    "(select max(d_date_sk) from date_dim where d_date between "
    "'1999-01-01' and '1999-06-30')",
    "insert into store_sales (select * from store_sales "
    "where ss_quantity > 90)",
]


def main(rank: int, world: int, out: str) -> None:
    import torch
    torch.set_num_threads(1)
    from nds_tpu_torch.datagen import tpcds
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.io.host_table import from_arrays
    from nds_tpu_torch.nds.schema import get_schemas
    from nds_tpu_torch.parallel import multihost
    from nds_tpu_torch.parallel.dist_exec import make_distributed_factory
    assert multihost.maybe_initialize(device="cpu")
    fac = make_distributed_factory(n_devices=world, device="cpu",
                                   shard_threshold=1000)
    sess = Session.for_nds(fac)
    schemas = get_schemas()
    for t in ("store_sales", "date_dim"):
        sess.register_table(from_arrays(t, schemas[t],
                                        tpcds.gen_table(t, SF)))
    res = {"before": sess.sql(SELECT).to_pandas()}
    ex = fac(sess.tables)
    assert ex._is_sharded("store_sales")
    for stmt in STMTS:
        sess.sql(stmt)
    res["after"] = sess.sql(SELECT).to_pandas()
    res["live_key"] = "store_sales.__live" in ex._buffers
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
