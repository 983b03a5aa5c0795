"""The 22 TPC-H queries of ``benchmarks/tpch.py``, written against the
port: one text a query, which ``chip_smoke.py`` runs on the card and the
parity tests run on the CPU.

Each query is a function of the table dict (``datagen.tpch_tables``:
lineitem, orders, customer, supplier, part, partsupp, nation, region) and
of the functions module ``F``, the port's by default. The texts follow the
benchmark's operation for operation, so both packages plan the same tree;
correlated subqueries are decorrelated there as Spark's optimizer lowers
them (grouped aggregates joined back, semi and anti joins, cross joins with
one-row aggregates). A few queries also have the intermediate results the
checks read: ``q3_groups`` and ``q18_groups`` (every group, before
ORDER BY and LIMIT), ``q8_parts`` (each year's numerator and denominator),
``q17_thresholds``/``q17_passing`` (the per-part threshold and the rows
under it, before the global sum) and ``q19_brands`` (the rows that meet
q19's common predicate, by brand).
"""

from __future__ import annotations

from . import functions as _F


def q1(t, F=_F):
    li = t["lineitem"]
    return (li.filter(F.col("l_shipdate") <= 10471)
            .withColumn("disc_price",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .withColumn("charge",
                        F.col("l_extendedprice") * (1 - F.col("l_discount"))
                        * (1 + F.col("l_tax")))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("l_quantity")).alias("avg_qty"),
                 F.avg(F.col("l_extendedprice")).alias("avg_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count(F.col("l_quantity")).alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q2(t, F=_F):
    """Minimum-cost supplier: the correlated min decorrelated into a
    grouped min joined back on (part, cost)."""
    supp, nation, region, part, ps = (t["supplier"], t["nation"],
                                      t["region"], t["part"], t["partsupp"])
    europe = region.filter(F.col("r_name") == "EUROPE")
    esupp = (supp.join(nation, on=supp["s_nationkey"] == nation["n_nationkey"])
             .join(europe, on=nation["n_regionkey"] == europe["r_regionkey"]))
    eps = ps.join(esupp, on=ps["ps_suppkey"] == esupp["s_suppkey"])
    min_cost = (eps.groupBy("ps_partkey")
                .agg(F.min(F.col("ps_supplycost")).alias("mc_cost"))
                .select(F.col("ps_partkey").alias("mc_partkey"),
                        F.col("mc_cost")))
    sel = part.filter((F.col("p_size") == 15)
                      & F.col("p_type").like("%BRASS"))
    big = sel.join(eps, on=sel["p_partkey"] == eps["ps_partkey"])
    return (big.join(min_cost,
                     on=(big["ps_partkey"] == min_cost["mc_partkey"])
                     & (big["ps_supplycost"] == min_cost["mc_cost"]))
            .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr")
            .sort(F.col("s_acctbal").desc(), "n_name", "s_name", "p_partkey")
            .limit(100))


def q3_groups(t, F=_F):
    """q3 without ORDER BY and LIMIT: every (order, date, revenue)
    group."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    return (cust.filter(F.col("c_mktsegment") == "BUILDING")
            .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
            .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
            .withColumn("revenue",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .groupBy("o_orderkey", "o_orderdate")
            .agg(F.sum(F.col("revenue")).alias("revenue")))


def q3(t, F=_F):
    return q3_groups(t, F).sort(F.col("revenue").desc()).limit(10)


def q4(t, F=_F):
    """Order-priority checking: a semi join on late lineitems."""
    li, orders = t["lineitem"], t["orders"]
    late = li.filter(F.col("l_commitdate") < F.col("l_receiptdate"))
    return (orders.filter((F.col("o_orderdate") >= 8582)
                          & (F.col("o_orderdate") < 8674))
            .join(late, on=orders["o_orderkey"] == late["l_orderkey"],
                  how="leftsemi")
            .groupBy("o_orderpriority")
            .agg(F.count_star().alias("order_count"))
            .sort("o_orderpriority"))


def q5(t, F=_F):
    """Local supplier volume: a five-way join down the region axis."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    supp, nation, region = t["supplier"], t["nation"], t["region"]
    asia = region.filter(F.col("r_name") == "ASIA")
    return (cust
            .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
            .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
            .join(supp, on=(li["l_suppkey"] == supp["s_suppkey"])
                  & (cust["c_nationkey"] == supp["s_nationkey"]))
            .join(nation, on=supp["s_nationkey"] == nation["n_nationkey"])
            .join(asia, on=nation["n_regionkey"] == asia["r_regionkey"])
            .filter((F.col("o_orderdate") >= 8766)
                    & (F.col("o_orderdate") < 9131))
            .withColumn("revenue",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .groupBy("n_name")
            .agg(F.sum(F.col("revenue")).alias("revenue"))
            .sort(F.col("revenue").desc()))


def q6(t, F=_F):
    li = t["lineitem"]
    return (li.filter((F.col("l_shipdate") >= 8766)
                      & (F.col("l_shipdate") < 9131)
                      & (F.col("l_discount") >= 0.05)
                      & (F.col("l_discount") <= 0.07)
                      & (F.col("l_quantity") < 24))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def q7(t, F=_F):
    """Volume shipping between FRANCE and GERMANY: the nation self-join
    through aliased projections."""
    li, orders, cust, supp, nation = (t["lineitem"], t["orders"],
                                      t["customer"], t["supplier"],
                                      t["nation"])
    n1 = nation.select(F.col("n_nationkey").alias("n1_key"),
                       F.col("n_name").alias("supp_nation"))
    n2 = nation.select(F.col("n_nationkey").alias("n2_key"),
                       F.col("n_name").alias("cust_nation"))
    pair = (((F.col("supp_nation") == "FRANCE")
             & (F.col("cust_nation") == "GERMANY"))
            | ((F.col("supp_nation") == "GERMANY")
               & (F.col("cust_nation") == "FRANCE")))
    return (li.filter((F.col("l_shipdate") >= 9131)
                      & (F.col("l_shipdate") <= 9861))
            .join(supp, on=li["l_suppkey"] == supp["s_suppkey"])
            .join(orders, on=li["l_orderkey"] == orders["o_orderkey"])
            .join(cust, on=orders["o_custkey"] == cust["c_custkey"])
            .join(n1, on=supp["s_nationkey"] == n1["n1_key"])
            .join(n2, on=cust["c_nationkey"] == n2["n2_key"])
            .filter(pair)
            .withColumn("volume",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .withColumn("l_year",
                        (F.col("l_shipdate").cast("int") / 365).cast("int"))
            .groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(F.col("volume")).alias("revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def _q8_years(t, F):
    """q8's rows grouped by order year, before its aggregate."""
    li, orders, cust, supp, nation, region, part = (
        t["lineitem"], t["orders"], t["customer"], t["supplier"],
        t["nation"], t["region"], t["part"])
    america = region.filter(F.col("r_name") == "AMERICA")
    n1 = nation.select(F.col("n_nationkey").alias("n1_key"),
                       F.col("n_regionkey").alias("n1_region"))
    n2 = nation.select(F.col("n_nationkey").alias("n2_key"),
                       F.col("n_name").alias("supp_nation"))
    steel = part.filter(F.col("p_type") == "ECONOMY ANODIZED STEEL")
    vol = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    return (steel.join(li, on=steel["p_partkey"] == li["l_partkey"])
            .join(supp, on=li["l_suppkey"] == supp["s_suppkey"])
            .join(orders, on=li["l_orderkey"] == orders["o_orderkey"])
            .join(cust, on=orders["o_custkey"] == cust["c_custkey"])
            .join(n1, on=cust["c_nationkey"] == n1["n1_key"])
            .join(america, on=n1["n1_region"] == america["r_regionkey"])
            .join(n2, on=supp["s_nationkey"] == n2["n2_key"])
            .filter((F.col("o_orderdate") >= 9131)
                    & (F.col("o_orderdate") <= 9861))
            .withColumn("volume", vol)
            .withColumn("brazil_volume",
                        F.when(F.col("supp_nation") == "BRAZIL",
                               F.col("volume")).otherwise(F.lit(0.0)))
            .withColumn("o_year",
                        (F.col("o_orderdate").cast("int") / 365).cast("int"))
            .groupBy("o_year"))


def q8(t, F=_F):
    """National market share: BRAZIL's slice of AMERICA's steel imports,
    a conditional-sum ratio per order year."""
    return (_q8_years(t, F)
            .agg((F.sum(F.col("brazil_volume"))
                  / F.sum(F.col("volume"))).alias("mkt_share"))
            .sort("o_year"))


def q8_parts(t, F=_F):
    """q8's numerator and denominator per order year."""
    return (_q8_years(t, F)
            .agg(F.sum(F.col("brazil_volume")).alias("brazil_volume"),
                 F.sum(F.col("volume")).alias("volume"))
            .sort("o_year"))


def q9(t, F=_F):
    """Product-type profit: part/supplier/partsupp/orders joins and
    LIKE."""
    li, orders = t["lineitem"], t["orders"]
    supp, nation, part, ps = (t["supplier"], t["nation"], t["part"],
                              t["partsupp"])
    green = part.filter(F.col("p_name").like("%green%"))
    return (li
            .join(green, on=li["l_partkey"] == green["p_partkey"])
            .join(supp, on=li["l_suppkey"] == supp["s_suppkey"])
            .join(ps, on=(li["l_suppkey"] == ps["ps_suppkey"])
                  & (li["l_partkey"] == ps["ps_partkey"]))
            .join(orders, on=li["l_orderkey"] == orders["o_orderkey"])
            .join(nation, on=supp["s_nationkey"] == nation["n_nationkey"])
            .withColumn("amount",
                        F.col("l_extendedprice") * (1 - F.col("l_discount"))
                        - F.col("ps_supplycost") * F.col("l_quantity"))
            .withColumn("o_year",
                        (F.col("o_orderdate").cast("int") / 365).cast("int"))
            .groupBy("n_name", "o_year")
            .agg(F.sum(F.col("amount")).alias("sum_profit"))
            .sort("n_name", F.col("o_year").desc()))


def q10(t, F=_F):
    """Returned-item reporting: revenue lost to returns per customer."""
    li, orders, cust, nation = (t["lineitem"], t["orders"], t["customer"],
                                t["nation"])
    returned = li.filter(F.col("l_returnflag") == "R")
    return (cust
            .join(orders, on=cust["c_custkey"] == orders["o_custkey"])
            .join(returned, on=orders["o_orderkey"] == returned["l_orderkey"])
            .join(nation, on=cust["c_nationkey"] == nation["n_nationkey"])
            .filter((F.col("o_orderdate") >= 8674)
                    & (F.col("o_orderdate") < 8766))
            .withColumn("revenue",
                        F.col("l_extendedprice") * (1 - F.col("l_discount")))
            .groupBy("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name")
            .agg(F.sum(F.col("revenue")).alias("revenue"))
            .sort(F.col("revenue").desc())
            .limit(20))


def q11(t, F=_F):
    """Important stock: per-part value against a fraction of the national
    total (a scalar subquery as a cross join with a one-row aggregate)."""
    ps, supp, nation = t["partsupp"], t["supplier"], t["nation"]
    ger = nation.filter(F.col("n_name") == "GERMANY")
    gps = (ps.join(supp, on=ps["ps_suppkey"] == supp["s_suppkey"])
           .join(ger, on=supp["s_nationkey"] == ger["n_nationkey"])
           .withColumn("value",
                       F.col("ps_supplycost") * F.col("ps_availqty")))
    per_part = (gps.groupBy("ps_partkey")
                .agg(F.sum(F.col("value")).alias("part_value")))
    total = gps.agg((F.sum(F.col("value")) * 0.0001).alias("threshold"))
    return (per_part.crossJoin(total)
            .filter(F.col("part_value") > F.col("threshold"))
            .select("ps_partkey", "part_value")
            .sort(F.col("part_value").desc(), "ps_partkey"))


def q12(t, F=_F):
    """Shipping modes and order priority: conditional aggregation."""
    li, orders = t["lineitem"], t["orders"]
    sel = li.filter(((F.col("l_shipmode") == "MAIL")
                     | (F.col("l_shipmode") == "SHIP"))
                    & (F.col("l_commitdate") < F.col("l_receiptdate"))
                    & (F.col("l_shipdate") < F.col("l_commitdate"))
                    & (F.col("l_receiptdate") >= 8766)
                    & (F.col("l_receiptdate") < 9131))
    high = ((F.col("o_orderpriority") == "1-URGENT")
            | (F.col("o_orderpriority") == "2-HIGH"))
    return (orders.join(sel, on=orders["o_orderkey"] == sel["l_orderkey"])
            .groupBy("l_shipmode")
            .agg(F.sum(F.when(high, 1).otherwise(0)).alias("high_line_count"),
                 F.sum(F.when(~high, 1).otherwise(0)).alias("low_line_count"))
            .sort("l_shipmode"))


def q13(t, F=_F):
    """Customer order-count distribution: a left join and a two-level
    aggregate."""
    orders, cust = t["orders"], t["customer"]
    sel = orders.filter(~F.col("o_orderpriority").like("%NOT%"))
    per_cust = (cust.join(sel, on=cust["c_custkey"] == sel["o_custkey"],
                          how="left")
                .groupBy("c_custkey")
                .agg(F.count(F.col("o_orderkey")).alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count_star().alias("custdist"))
            .sort(F.col("custdist").desc(), F.col("c_count").desc()))


def q14(t, F=_F):
    """Promotion effect: a conditional revenue ratio."""
    li, part = t["lineitem"], t["part"]
    sel = li.filter((F.col("l_shipdate") >= 9374)
                    & (F.col("l_shipdate") < 9404))
    joined = sel.join(part, on=sel["l_partkey"] == part["p_partkey"])
    rev = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    promo = F.col("p_type").like("PROMO%")
    return joined.agg(
        (F.sum(F.when(promo, rev).otherwise(F.lit(0.0))) * 100.0
         / F.sum(rev)).alias("promo_revenue"))


def q15(t, F=_F):
    """Top supplier: the max-revenue scalar subquery over a revenue view,
    revenue rounded to cents before the equality selection."""
    li, supp = t["lineitem"], t["supplier"]
    rev = (li.filter((F.col("l_shipdate") >= 9496)
                     & (F.col("l_shipdate") < 9587))
           .withColumn("r", F.col("l_extendedprice") * (1 - F.col("l_discount")))
           .groupBy("l_suppkey")
           .agg(F.round(F.sum(F.col("r")), 2).alias("total_revenue")))
    maxr = rev.agg(F.max(F.col("total_revenue")).alias("max_revenue"))
    return (supp.join(rev, on=supp["s_suppkey"] == rev["l_suppkey"])
            .crossJoin(maxr)
            .filter(F.col("total_revenue") == F.col("max_revenue"))
            .select("s_suppkey", "s_name", "total_revenue")
            .sort("s_suppkey"))


def q16(t, F=_F):
    """Parts/supplier relationship: NOT IN as an anti join, then
    COUNT(DISTINCT supplier) as a distinct and a count."""
    ps, part, supp = t["partsupp"], t["part"], t["supplier"]
    bad = supp.filter(F.col("s_comment").like("%Customer%Complaints%"))
    sel = part.filter((F.col("p_brand") != "Brand#45")
                      & ~F.col("p_type").like("MEDIUM POLISHED%")
                      & F.col("p_size").isin(49, 14, 23, 45, 19, 3, 36, 9))
    j = (ps.join(sel, on=ps["ps_partkey"] == sel["p_partkey"])
         .join(bad, on=ps["ps_suppkey"] == bad["s_suppkey"],
               how="leftanti"))
    return (j.select("p_brand", "p_type", "p_size", "ps_suppkey").distinct()
            .groupBy("p_brand", "p_type", "p_size")
            .agg(F.count_star().alias("supplier_cnt"))
            .sort(F.col("supplier_cnt").desc(), "p_brand", "p_type",
                  "p_size"))


def _q17_parts(t, F):
    """q17's joined lineitems and each part's 0.2 * avg(quantity)."""
    li, part = t["lineitem"], t["part"]
    sel = part.filter((F.col("p_brand") == "Brand#23")
                      & (F.col("p_container") == "MED BOX"))
    j = li.join(sel, on=li["l_partkey"] == sel["p_partkey"])
    thresh = (j.groupBy("p_partkey")
              .agg((F.avg(F.col("l_quantity")) * 0.2).alias("qty_thresh"))
              .select(F.col("p_partkey").alias("th_partkey"),
                      F.col("qty_thresh")))
    passing = (j.join(thresh, on=j["p_partkey"] == thresh["th_partkey"])
               .filter(F.col("l_quantity") < F.col("qty_thresh")))
    return thresh, passing


def q17(t, F=_F):
    """Small-quantity-order revenue: the correlated per-part average
    decorrelated into a grouped average joined back."""
    _, passing = _q17_parts(t, F)
    return passing.agg((F.sum(F.col("l_extendedprice")) / 7.0)
                       .alias("avg_yearly"))


def q17_thresholds(t, F=_F):
    """q17's per-part threshold, by part."""
    return _q17_parts(t, F)[0].sort("th_partkey")


def q17_passing(t, F=_F):
    """q17's lineitems under their part's threshold, before the global
    sum."""
    return (_q17_parts(t, F)[1]
            .select("p_partkey", "l_quantity", "l_extendedprice",
                    "qty_thresh")
            .sort("p_partkey", "l_quantity", "l_extendedprice"))


def q18_groups(t, F=_F):
    """q18 without ORDER BY and LIMIT: orders of more than 150 units (a
    left semi join against a grouped lineitem), with their customer and
    their lineitems' quantity."""
    li, orders, cust = t["lineitem"], t["orders"], t["customer"]
    big = (li.groupBy("l_orderkey")
           .agg(F.sum(F.col("l_quantity")).alias("total_qty"))
           .filter(F.col("total_qty") > 150))
    return (orders
            .join(big, on=orders["o_orderkey"] == big["l_orderkey"],
                  how="leftsemi")
            .join(cust, on=orders["o_custkey"] == cust["c_custkey"])
            .join(li, on=orders["o_orderkey"] == li["l_orderkey"])
            .groupBy("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                     "o_totalprice")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty")))


def q18(t, F=_F):
    return (q18_groups(t, F)
            .sort(F.col("o_totalprice").desc(), "o_orderdate").limit(100))


def q19(t, F=_F):
    """Discounted revenue: disjunctive bracketed predicates."""
    li, part = t["lineitem"], t["part"]
    j = li.join(part, on=li["l_partkey"] == part["p_partkey"])
    qty, size = F.col("l_quantity"), F.col("p_size")
    common = (((F.col("l_shipmode") == "AIR")
               | (F.col("l_shipmode") == "REG AIR"))
              & (F.col("l_shipinstruct") == "DELIVER IN PERSON"))
    b1 = ((F.col("p_brand") == "Brand#12")
          & F.col("p_container").like("SM%")
          & (qty >= 1) & (qty <= 11) & (size >= 1) & (size <= 5))
    b2 = ((F.col("p_brand") == "Brand#23")
          & F.col("p_container").like("MED%")
          & (qty >= 10) & (qty <= 20) & (size >= 1) & (size <= 10))
    b3 = ((F.col("p_brand") == "Brand#34")
          & F.col("p_container").like("LG%")
          & (qty >= 20) & (qty <= 30) & (size >= 1) & (size <= 15))
    return (j.filter(common & (b1 | b2 | b3))
            .agg(F.sum(F.col("l_extendedprice") * (1 - F.col("l_discount")))
                 .alias("revenue")))


def q19_brands(t, F=_F):
    """q19's lineitems that meet its common predicate (ship mode and
    instruction), joined to their part: count and revenue by brand."""
    li, part = t["lineitem"], t["part"]
    j = li.join(part, on=li["l_partkey"] == part["p_partkey"])
    common = (((F.col("l_shipmode") == "AIR")
               | (F.col("l_shipmode") == "REG AIR"))
              & (F.col("l_shipinstruct") == "DELIVER IN PERSON"))
    return (j.filter(common)
            .groupBy("p_brand")
            .agg(F.count_star().alias("lines"),
                 F.sum(F.col("l_extendedprice") * (1 - F.col("l_discount")))
                 .alias("revenue"))
            .sort("p_brand"))


def q20(t, F=_F):
    """Potential part promotion: nested IN subqueries as semi joins over a
    half-of-shipped-quantity threshold (EGYPT, whose suppliers qualify
    under this generator's seed, in place of dbgen's CANADA)."""
    li, ps, part, supp, nation = (t["lineitem"], t["partsupp"], t["part"],
                                  t["supplier"], t["nation"])
    forest = part.filter(F.col("p_name").like("forest%"))
    fps = ps.join(forest, on=ps["ps_partkey"] == forest["p_partkey"],
                  how="leftsemi")
    ship94 = (li.filter((F.col("l_shipdate") >= 8766)
                        & (F.col("l_shipdate") < 9131))
              .groupBy("l_partkey", "l_suppkey")
              .agg((F.sum(F.col("l_quantity")) * 0.5).alias("half_qty")))
    qual = (fps.join(ship94,
                     on=(fps["ps_partkey"] == ship94["l_partkey"])
                     & (fps["ps_suppkey"] == ship94["l_suppkey"]))
            .filter(F.col("ps_availqty") > F.col("half_qty")))
    egypt = nation.filter(F.col("n_name") == "EGYPT")
    return (supp.join(qual, on=supp["s_suppkey"] == qual["ps_suppkey"],
                      how="leftsemi")
            .join(egypt, on=supp["s_nationkey"] == egypt["n_nationkey"])
            .select("s_name")
            .sort("s_name"))


def q21(t, F=_F):
    """Suppliers who kept orders waiting: the EXISTS/NOT EXISTS pair
    decorrelated into distinct (order, supplier) pair counts and two semi
    joins."""
    li, orders, supp, nation = (t["lineitem"], t["orders"], t["supplier"],
                                t["nation"])
    late = li.filter(F.col("l_receiptdate") > F.col("l_commitdate"))
    multi = (li.select("l_orderkey", "l_suppkey").distinct()
             .groupBy("l_orderkey")
             .agg(F.count_star().alias("nsupp"))
             .filter(F.col("nsupp") > 1)
             .select(F.col("l_orderkey").alias("multi_key")))
    one_late = (late.select("l_orderkey", "l_suppkey").distinct()
                .groupBy("l_orderkey")
                .agg(F.count_star().alias("nlate"))
                .filter(F.col("nlate") == 1)
                .select(F.col("l_orderkey").alias("late_key")))
    f_orders = orders.filter(F.col("o_orderstatus") == "F")
    saudi = nation.filter(F.col("n_name") == "SAUDI ARABIA")
    l1 = (late.join(f_orders, on=late["l_orderkey"] == f_orders["o_orderkey"])
          .join(supp, on=late["l_suppkey"] == supp["s_suppkey"])
          .join(saudi, on=supp["s_nationkey"] == saudi["n_nationkey"]))
    return (l1.join(multi, on=l1["l_orderkey"] == multi["multi_key"],
                    how="leftsemi")
            .join(one_late, on=l1["l_orderkey"] == one_late["late_key"],
                  how="leftsemi")
            .groupBy("s_name")
            .agg(F.count_star().alias("numwait"))
            .sort(F.col("numwait").desc(), "s_name")
            .limit(100))


#: q22's country codes: codes with orderless customers under this
#: generator's seed (dbgen's codes do not occur in the synthetic phones)
Q22_CODES = ["04", "27", "81", "55", "35", "61", "68"]


def q22(t, F=_F):
    """Global sales opportunity: a phone-prefix cohort, the scalar average
    as a cross join, NOT EXISTS as an anti join."""
    cust, orders = t["customer"], t["orders"]
    cohort = (cust.withColumn("cntrycode",
                              F.substring(F.col("c_phone"), 1, 2))
              .filter(F.col("cntrycode").isin(*Q22_CODES)))
    avg_bal = (cohort.filter(F.col("c_acctbal") > 0.0)
               .agg(F.avg(F.col("c_acctbal")).alias("avg_bal")))
    no_orders = cohort.join(
        orders, on=cohort["c_custkey"] == orders["o_custkey"],
        how="leftanti")
    return (no_orders.crossJoin(avg_bal)
            .filter(F.col("c_acctbal") > F.col("avg_bal"))
            .groupBy("cntrycode")
            .agg(F.count_star().alias("numcust"),
                 F.sum(F.col("c_acctbal")).alias("totacctbal"))
            .sort("cntrycode"))


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
           "q7": q7, "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12,
           "q13": q13, "q14": q14, "q15": q15, "q16": q16, "q17": q17,
           "q18": q18, "q19": q19, "q20": q20, "q21": q21, "q22": q22}
