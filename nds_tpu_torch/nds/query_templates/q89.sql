select *
from (select i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price))
               over (partition by i_category, i_brand, s_store_name,
                                  s_company_name) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and d_year in ({year})
        and ((i_category in ('Books', 'Electronics', 'Sports')
              and i_class in ('booksclass2', 'electronicsclass5',
                              'sportsclass8'))
          or (i_category in ('Men', 'Jewelry', 'Women')
              and i_class in ('menclass1', 'jewelryclass3',
                              'womenclass7')))
      group by i_category, i_class, i_brand, s_store_name,
               s_company_name, d_moy) tmp1
where case when avg_monthly_sales <> 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
